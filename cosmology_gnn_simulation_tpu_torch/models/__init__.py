"""The Encode-Process-Decode model as plain functions over param dicts."""

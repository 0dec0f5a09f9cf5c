"""The program's entry points that a traffic mix drives, by name."""

"""``BENCHMARK.json`` against the benchmark's rules, and every name in it
found as a file; no name of a cell, configuration or metric in the
harness's code."""

import json
import re
from pathlib import Path

from portbench import harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
LINE = re.compile(r"^[^\n\t]{1,200}$")


def test_top_level():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert 1 <= len(BENCH["command"]) <= 32 and all(LINE.match(w) for w in BENCH["command"])
    for path in BENCH["paths"]:
        assert re.match(r"^[A-Za-z0-9_.\-/]{1,200}$", path) and (ROOT / path).is_dir()


def test_entries_and_names():
    keys = {"configs": {"name", "source", "file", "reduced", "why"},
            "workloads": {"name", "config", "traffic", "chips", "why"},
            "end_to_end": {"name", "unit", "better", "bound", "source"},
            "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}
    names = []
    for kind, required in keys.items():
        for entry in BENCH[kind]:
            assert set(entry) - {"workloads"} == required, entry
            assert NAME.match(entry["name"]), entry["name"]
            names.append(entry["name"])
            for key in ("why", "layer", "source"):
                if key in entry:
                    assert LINE.match(entry[key]), entry[key]
    assert len(names) == len(set(names))
    for metric in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(metric["unit"]), metric["unit"]
        assert metric["better"] in ("lower", "higher")
    for metric in BENCH["end_to_end"]:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    for cell in BENCH["workloads"]:
        assert NAME.match(cell["config"]) and NAME.match(cell["traffic"])
        assert cell["chips"] in (1, 4)


def test_every_cell_reports_enough():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    layers = {}
    for metric in BENCH["per_layer"]:
        assert metric["moves"] in e2e
        layers.setdefault(metric["layer"], metric["layer"])
    for cell in BENCH["workloads"]:
        name = cell["name"]
        reported = [m for m in BENCH["end_to_end"] if name in m.get("workloads", [name])]
        assert len(reported) >= 2
        own = [m for m in BENCH["per_layer"] if name in m.get("workloads", [name])]
        assert own
        for metric in own:
            assert name in e2e[metric["moves"]].get("workloads", [name])


def test_names_are_files():
    files = {c["name"]: c["file"] for c in BENCH["configs"]}
    for config in BENCH["configs"]:
        assert config["file"].startswith("portbench/")
        assert json.loads((ROOT / config["file"]).read_text())["reduced"] == config["reduced"]
    assert len(set(files.values())) == len(files)
    for cell in BENCH["workloads"]:
        assert cell["config"] in files
        assert (ROOT / "portbench" / "workloads" / f"{cell['traffic']}.json").is_file()
        assert (ROOT / "portbench" / "limits" / f"{cell['name']}.json").is_file()
    for metric in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert harness.reader_path(metric["name"]).is_file(), metric["name"]
    used = {c["config"] for c in BENCH["workloads"]}
    assert used == set(files)


def test_no_cell_config_or_metric_name_in_the_harness():
    names = [c["name"] for c in BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"]
             + BENCH["per_layer"]]
    names += [c["traffic"] for c in BENCH["workloads"]]
    code = ["run.py", "harness.py", "tracing.py", "system.py", "control.py", "faults.py"]
    code += [f"entries/{p.name}" for p in (ROOT / "portbench" / "entries").glob("*.py")]
    for path in code:
        text = (ROOT / "portbench" / path).read_text()
        for name in names:
            assert not re.search(rf"(?<![\w.]){re.escape(name)}(?![\w.])", text), (path, name)

"""BENCHMARK.json keeps to the benchmark's contract: its keys, names,
units, bounds and per-layer entries, and every file it names is under its
paths."""
import json
import re
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    assert 1 <= len(BENCH["command"]) <= 32
    assert all(line(w) for w in BENCH["command"])
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p)
        assert not p.startswith("/") and ".." not in p.split("/")
        assert (REPO / p).is_dir() and not p.endswith("_torch")
    for w in BENCH["command"][1:]:
        if "/" in w:
            assert any(w.startswith(p + "/") for p in BENCH["paths"])


def under_paths(f):
    return any(f.startswith(p + "/") for p in BENCH["paths"])


def test_configs():
    files = [c["file"] for c in BENCH["configs"]]
    assert 1 <= len(BENCH["configs"]) <= 24 and len(set(files)) == len(files)
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] in used
        assert line(c["source"]) and line(c["why"])
        assert under_paths(c["file"]) and (REPO / c["file"]).is_file()
        body = json.loads((REPO / c["file"]).read_text())
        assert body["name"] == c["name"]
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) and k in body for k in c["reduced"])


def test_workloads():
    ws = BENCH["workloads"]
    assert 1 <= len(ws) <= 24
    assert len({w["name"] for w in ws}) == len(ws)
    assert len({(w["config"], w["traffic"]) for w in ws}) == len(ws)
    assert sum(w["chips"] == 4 for w in ws) <= max(1, len(ws) // 4)
    configs = {c["name"] for c in BENCH["configs"]}
    for w in ws:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert line(w["why"])
        assert (REPO / "rtbench/traffic" / f"{w['traffic']}.json").is_file()


def test_metrics():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    per = BENCH["per_layer"]
    names = list(e2e) + [m["name"] for m in per]
    assert len(set(names)) == len(names)
    assert 1 <= len(e2e) <= 16 and 1 <= len(per) <= 128
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in per:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in SOURCES and m["moves"] in e2e
        assert line(m["layer"])
        assert set(m.get("workloads", cells)) <= cells
        assert (REPO / "rtbench/metrics" / f"{m['name']}.py").is_file()
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for m in BENCH["end_to_end"] + per:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    layers = {}
    for m in per:
        layers.setdefault(m["layer"].split(" (")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_reports_enough(cell):
    def mine(m):
        return cell in m.get("workloads", [cell])

    e2e = [m["name"] for m in BENCH["end_to_end"] if mine(m)]
    assert "setup_s" in e2e and len(e2e) >= 2
    per = [m for m in BENCH["per_layer"] if mine(m)]
    assert per and all(m["moves"] in e2e for m in per)

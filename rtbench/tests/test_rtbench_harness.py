"""Whole runs of tiny test-only cells on the CPU (the program's plain
versions): a sound run is correct, a result line has the keys the
contract asks for, and cells, configurations and metrics added as new
files are picked up with no edit to the harness."""
import json
import time

import pytest

from rtbench import harness
from rtbench.queries import closest
from rtbench.tests import tiny

RESULT_KEYS = ["correct", "attempted", "failed", "metrics", "device",
               "checks"]


def run(root, cell, seed=3_000_000_017, trace=False, **kw):
    return harness.run_cell(root, cell, seed, 0.3, trace, "cpu",
                            time.perf_counter(), log=lambda *_: None, **kw)


@pytest.mark.parametrize("cell", ["tiny-primary", "tiny-bounce"])
def test_sound_run_is_correct(tmp_path, cell):
    r = run(tiny.make_root(tmp_path), cell)
    assert r["correct"], r["checks"]
    assert list(r) == RESULT_KEYS
    assert r["attempted"] > 0 and r["failed"] == 0
    assert set(r["metrics"]) == {"mrays_per_s", "call_ms_p95", "setup_s"}
    assert all(v["value"] > 0 for v in r["metrics"].values())
    assert set(r["checks"]) == set(closest.CHECKS)


KIND = """import torch

from rtbench.traffic.generate import device_generator


def make(t, seed, soup, device):
    out = []
    for b in range(t["batches"]):
        g = device_generator(seed, 5000 + b, device)
        n = t["rays"]
        d = torch.randn((n, 3), generator=g, device=device) * 0.2
        d = d + torch.tensor([0.0, 0.0, -1.0], device=device)
        d = d / torch.linalg.vector_norm(d, dim=1, keepdim=True)
        o = torch.tensor([0.0, 0.0, 3.0], device=device).expand(n, 3)
        out.append(dict(origin=o.contiguous(), direction=d,
                        min_t=torch.zeros(n, device=device),
                        max_t=torch.full((n,), 1e30, device=device)))
    return out
"""


def test_added_files_are_picked_up(tmp_path):
    root = tiny.make_root(tmp_path)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    # A configuration, a query kind, a traffic mix of a new kind and a
    # per-layer metric, each a new file, and the entries that name them.
    cfg = dict(tiny.CONFIG, name="tiny-blob1", triangles=80,
               scene={"generator": "blob", "args": {"subdivisions": 1}},
               query=dict(tiny.CONFIG["query"], kind="test_closest"))
    (root / "rtbench/configs/tiny-blob1.json").write_text(json.dumps(cfg))
    (root / "rtbench/queries/test_closest.py").write_text(
        "from rtbench.queries.closest import CHECKS, Program, check\n"
        "__all__ = ['CHECKS', 'Program', 'check']\n")
    (root / "rtbench/traffic/kinds/test_fan.py").write_text(KIND)
    traffic = dict(tiny.TRAFFIC["tiny-orbit"], kind="test_fan", rays=300,
                   batches=2)
    (root / "rtbench/traffic/tiny-fan.json").write_text(json.dumps(traffic))
    (root / "rtbench/metrics/test.call_ms_max.py").write_text(
        "def read(r):\n    return max(r.walls_ms) if r.walls_ms else None\n")
    (root / "rtbench/metrics/test.nothing.py").write_text(
        "def read(r):\n    return None\n")
    bench["configs"].append({"name": "tiny-blob1", "source": "test",
                             "file": "rtbench/configs/tiny-blob1.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "tiny-added", "config": "tiny-blob1",
                               "traffic": "tiny-fan", "chips": 1,
                               "why": "test"})
    for name in ("test.call_ms_max", "test.nothing"):
        bench["per_layer"].append({
            "name": name, "unit": "ms", "better": "lower",
            "source": "host_clock", "layer": "test", "moves": "call_ms_p95",
            "workloads": ["tiny-added"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    r = run(root, "tiny-added", trace=True)
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0
    # The reader that finds nothing is left out of the line.
    assert set(r["metrics"]) == {"test.call_ms_max"}
    assert r["metrics"]["test.call_ms_max"]["value"] > 0
    # The other cells do not report a metric listed for tiny-added alone.
    assert run(root, "tiny-primary", trace=True)["metrics"] == {}


def edit(root, cfg=None, traffic=None):
    """Change tiny-primary's configuration or traffic in place."""
    if cfg is not None:
        (root / "rtbench/configs/tiny-blob.json").write_text(json.dumps(
            dict(tiny.CONFIG, **cfg)))
    if traffic is not None:
        (root / "rtbench/traffic/tiny-orbit.json").write_text(json.dumps(
            dict(tiny.TRAFFIC["tiny-orbit"], **traffic)))


@pytest.mark.parametrize("change", [
    {"cfg": {"query": dict(tiny.CONFIG["query"], kind="any")}},
    {"cfg": {"query": dict(tiny.CONFIG["query"], precision="bfloat16")}},
    {"cfg": {"query": dict(tiny.CONFIG["query"], record=["hit", "t"])}},
    {"cfg": {"triangles": 321}},
    {"cfg": {"meshes": 2}},
    {"traffic": {"kind": "shadow"}},
], ids=["query-kind", "precision", "record", "triangles", "meshes",
        "traffic-kind"])
def test_what_the_harness_cannot_run_is_refused(tmp_path, change):
    # A configuration or traffic that states what no file of the
    # benchmark runs ends the run, never runs as something else.
    root = tiny.make_root(tmp_path)
    edit(root, **change)
    with pytest.raises(ValueError):
        run(root, "tiny-primary")


def test_same_seed_same_answers(tmp_path):
    root = tiny.make_root(tmp_path)
    a, b = (run(root, "tiny-bounce", seed=77) for _ in range(2))
    assert a["checks"] == b["checks"]

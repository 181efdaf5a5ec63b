"""A benchmark root with tiny test-only cells, for driving whole runs on
the CPU: a copy of rtbench/ beside a BENCHMARK.json of its own, so that
cells, configurations and metrics can be added as new files."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
LIMITS = {"t_gap": 1e-4, "record_gap": 5e-4, "record_bad_share": 5e-3}
CONFIG = {
    "name": "tiny-blob", "scene": {"generator": "blob",
                                   "args": {"subdivisions": 2}},
    "triangles": 320, "meshes": 1,
    "build": {"builder": "lbvh", "width": 8, "leaf_size": 4,
              "morton_bits": 10},
    "query": {"kind": "closest", "test": "watertight", "precision": "float32",
              "record": ["hit", "t", "u", "v", "triangle_index",
                         "mesh_index"]}}
TRAFFIC = {
    "tiny-orbit": {
        "kind": "primary", "side": 32, "batches": 3, "orbit_deg": 10.0,
        "max_t": 1e30,
        "views": [{"eye": [0, 0, 3], "look_at": [0, 0, 0], "up": [0, 1, 0],
                   "fov_deg": 45},
                  {"eye": [3, 0.5, 0], "look_at": [0, 0, 0],
                   "up": [0, 1, 0], "fov_deg": 45}],
        "check": {"calls": 2, "rays": 256, "limits": LIMITS}},
    "tiny-bounce": {
        "kind": "bounce", "rays": 1024, "batches": 2, "eps": 1e-3,
        "max_t": 1e30, "eyes": [[0, 0, 3], [0, 3, 0]],
        "check": {"calls": 2, "rays": 256, "limits": LIMITS}},
}


def make_root(tmp: Path, per_layer=()) -> Path:
    """A root under tmp with the cells tiny-primary and tiny-bounce on the
    configuration tiny-blob; per_layer: BENCHMARK.json's per-layer
    entries."""
    root = tmp / "root"
    shutil.copytree(REPO / "rtbench", root / "rtbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (root / "rtbench" / "configs" / "tiny-blob.json").write_text(
        json.dumps(CONFIG))
    for name, t in TRAFFIC.items():
        (root / "rtbench" / "traffic" / f"{name}.json").write_text(
            json.dumps(t))
    bench = {
        "command": ["python3", "rtbench/run.py"], "paths": ["rtbench"],
        "run_seconds": 1,
        "configs": [{"name": "tiny-blob", "source": "test",
                     "file": "rtbench/configs/tiny-blob.json",
                     "reduced": [], "why": "test"}],
        "workloads": [
            {"name": "tiny-primary", "config": "tiny-blob",
             "traffic": "tiny-orbit", "chips": 1, "why": "test"},
            {"name": "tiny-bounce", "config": "tiny-blob",
             "traffic": "tiny-bounce", "chips": 1, "why": "test"}],
        # The benchmark's end-to-end metrics, each in every tiny cell.
        "end_to_end": [{k: v for k, v in m.items() if k != "workloads"}
                       for m in json.loads(
                           (REPO / "BENCHMARK.json").read_text())[
                               "end_to_end"]],
        "per_layer": list(per_layer)}
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root

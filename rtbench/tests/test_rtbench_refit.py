"""The `refit` query kind and the `deform_grid` scene generator on a tiny
deforming cell on the CPU: a whole run is correct and its check reads 0,
one warm call refits and repacks once; three broken programs fail the
check (the rest pose traced with no refit, a refit the Tracer is not
refreshed to, the plain reference in bfloat16 in the program's place);
the generator's frames are the program's own; the refit spans' readers on
hand-made windows."""
import json
import math
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from rtbench import harness, reference
from rtbench.harness import Readings
from rtbench.loader import load_module
from rtbench.queries import closest, refit
from rtbench.scenes import deform_grid
from rtbench.tests import tiny

REPO = Path(__file__).resolve().parents[2]
METRICS = REPO / "rtbench" / "metrics"
CELL = "tiny-deform"
TRAFFIC = json.loads((REPO / "rtbench/traffic/deform-primary-256.json")
                     .read_text())
N = 8  # the tiny grid: 2 * 8 * 8 = 128 triangles, 16 leaves of 8
CONFIG = {
    "name": "tiny-grid-deform",
    "scene": {"generator": "deform_grid", "args": {"n": N, "extent": 2.0}},
    "triangles": 2 * N * N, "meshes": 1,
    "build": {"builder": "lbvh", "width": 8, "leaf_size": 8,
              "morton_bits": 10, "wide_nodes": False},
    "query": dict(json.loads((REPO / "rtbench/configs/"
                              "grid96-deform-lbvh8-leaf8.json").read_text())[
                                  "query"], clip={"frames": 5, "dt": 0.05})}
# The cell's own views and limits, at 32^2 rays a batch.
TINY_TRAFFIC = dict(TRAFFIC, side=32, batches=3,
                    check=dict(TRAFFIC["check"], calls=3, rays=256))
SEED = 3_000_000_031


def make_root(tmp):
    root = tiny.make_root(tmp)
    (root / "rtbench/configs/tiny-grid-deform.json").write_text(
        json.dumps(CONFIG))
    (root / "rtbench/traffic/tiny-deform.json").write_text(
        json.dumps(TINY_TRAFFIC))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny-grid-deform", "source": "test",
                             "file": "rtbench/configs/tiny-grid-deform.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": CELL, "config": "tiny-grid-deform",
                               "traffic": "tiny-deform", "chips": 1,
                               "why": "test"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def run(tmp, program=None, log=lambda *_: None):
    return harness.run_cell(make_root(tmp), CELL, SEED, 0.3, False, "cpu",
                            time.perf_counter(), log=log, program=program)


def test_sound_run_reads_zero(tmp_path):
    lines = []
    r = run(tmp_path, log=lines.append)
    assert r["correct"], r["checks"]
    assert {k: v["value"] for k, v in r["checks"].items()} == {
        "t_gap": 0.0, "record_gap": 0.0, "record_bad_share": 0.0}
    assert r["attempted"] > 0 and r["failed"] == 0
    assert set(r["metrics"]) == {"mrays_per_s", "call_ms_p95", "setup_s"}
    # notes: one warm call refits and repacks once; the range table has
    # ceil(log2 16) + 1 levels; no CUDA launch on the CPU.
    note = next(x for x in lines if x.startswith("one warm call"))
    got = json.loads(note.split(": ", 1)[1])
    assert got["REFITS"] == 1 and got["REPACKS"] == 1
    assert got["REFIT_LEVELS"] == math.ceil(math.log2(2 * N * N / 8)) + 1
    assert got["KERNEL_LAUNCHES"] == 0


def test_calls_walk_the_clip(tmp_path):
    root = make_root(tmp_path)
    cell = harness.load_cell(root, CELL)
    positions, indices = harness.scene_of(cell)
    prog = refit.Program(cell, positions, indices, "cpu")
    assert prog.frames.shape == (5, 2 * N * N, 3, 3)
    assert prog.scene.has_wide is False
    rays = prog.rays({
        "origin": torch.tensor([[0.0, 3.0, 4.0]]),
        "direction": torch.tensor([[0.0, -0.6, -0.8]]),
        "min_t": torch.zeros(1), "max_t": torch.full((1,), 1e30)})
    frames = [prog(rays)[-1] for _ in range(7)]
    assert frames == [0, 1, 2, 3, 4, 0, 1]
    # The last refit holds frame 1's vertices in the sorted order.
    soup = positions[indices]
    want = torch.as_tensor(deform_grid.frame(soup, 0.05))
    perm = prog.scene.perm.long()
    assert torch.equal(prog.scene.tri_v[perm >= 0], want[perm[perm >= 0]])


def test_the_cells_warm_call_counts():
    """deform-refit-256's own configuration on the CPU, one warm call of a
    16^2 batch: one refit and one repack, and a range table of
    ceil(log2(18,432 / 8)) + 1 = 13 levels."""
    from rtbench.traffic import generate

    cell = harness.load_cell(REPO, "deform-refit-256")
    positions, indices = harness.scene_of(cell)
    prog = refit.Program(cell, positions, indices, "cpu")
    assert prog.frames.shape == (32, 18_432, 3, 3)
    batch = generate.make(dict(cell["traffic"], side=16, batches=1),
                          SEED, None, "cpu")[0]
    prog.rays(batch)
    got = json.loads(prog.notes(256)[-1].split(": ", 1)[1])
    assert (got["REFITS"], got["REPACKS"], got["REFIT_LEVELS"]) == (1, 1, 13)


class RestPose(refit.Program):
    """Traces the rest pose: no refit."""

    def __call__(self, rays):
        i = self.calls % self.frames.shape[0]
        self.calls += 1
        return closest.records(self.tracer.closest(rays)) + (i,)


class NoRefresh(refit.Program):
    """Refits the scene, but traces the Tracer's old tables."""

    def __call__(self, rays):
        i = self.calls % self.frames.shape[0]
        self.calls += 1
        self.scene = self.rt.refit(self.scene, self.frames[i])
        return closest.records(self.tracer.closest(rays)) + (i,)


class Control(refit.Program):
    """The plain reference in bfloat16 on the frame, in the program's
    place."""

    def __call__(self, rays):
        i = self.calls % self.frames.shape[0]
        self.calls += 1
        hit, t, u, v, idx = reference.closest(
            self.frames[i], rays.origin, rays.direction, rays.min_t,
            rays.max_t, dtype=torch.bfloat16)
        return (hit, t, u, v, idx.to(torch.int32),
                torch.where(hit, 0, -1).to(torch.int32), i)


@pytest.mark.parametrize("program", [RestPose, NoRefresh, Control],
                         ids=lambda p: p.__name__)
def test_fault_is_not_correct(tmp_path, program):
    r = run(tmp_path, program)
    assert not r["correct"], r["checks"]


def test_calibrate_reads_program_and_control(tmp_path):
    from rtbench import calibrate

    root = make_root(tmp_path)
    out = tmp_path / "cal.jsonl"
    calibrate.main(["--workload", CELL, "--seeds", "8", "9", "--seconds",
                    "0.2", "--device", "cpu", "--out", str(out)], root=root)
    limits = TRAFFIC["check"]["limits"]
    for line in map(json.loads, out.read_text().splitlines()):
        assert all(line["program"][k] == 0 for k in limits)
        assert any(line["control_bf16"][k] > limits[k] for k in limits)


@pytest.mark.parametrize("t", [0.35, 1.55])
def test_frames_are_the_programs(t):
    from rtk_tpu_torch.testing import scenes

    v, f = deform_grid.make(n=96, extent=2.0)
    assert f.shape == (18_432, 3) and f.dtype == np.int32
    np.testing.assert_array_equal(v[f].view(np.int32),
                                  scenes.deforming_grid(0.0).view(np.int32))
    got = deform_grid.frame(v[f], t)
    want = scenes.deforming_grid(t, n=96)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


# ---- the refit spans' readers ----

NAMES = ("refit.host_ms", "refit.repack_host_ms", "refit.idle_pct")


def reader(name):
    return load_module(METRICS / f"{name}.py").read


def frame_window(shift=0.0):
    """Two calls 1000 us apart: a refit span (300 us) whose device records
    leave the card idle 40 us inside it, a repack span (100 us) with 20 us
    idle inside it, then the trace."""
    from rtbench import devtrace

    device, host = [], []
    for c in range(2):
        t = shift + 1000.0 * c
        host += [("rtbench.call", t, t + 900),
                 ("rtk.refit", t + 10, t + 310),
                 ("rtk.repack", t + 310, t + 410),
                 ("rtk.tracer.closest", t + 410, t + 600),
                 ("rtbench.sync", t + 600, t + 900)]
        device += [("gather", t + 100, t + 200),
                   ("minimum", t + 240, t + 330),
                   ("index", t + 350, t + 700)]
    return devtrace.Window(device=device, host=host, lead=1, tail=1,
                           calls=2)


def test_readers_exact():
    r = Readings([], [], [frame_window(), frame_window(shift=5000.0)])
    assert reader("refit.host_ms")(r) == pytest.approx(0.300)
    assert reader("refit.repack_host_ms")(r) == pytest.approx(0.100)
    # Each window: 1600 us from its first device record (100) to its last
    # (1700); each call's card idles 40 us inside its refit (200-240) and
    # 20 inside its repack (330-350), and between the calls 700-1100, of
    # which 1010-1100 is inside the next call's refit: 210 us a window.
    assert reader("refit.idle_pct")(r) == pytest.approx(100.0 * 210 / 1600)


@pytest.mark.parametrize("name", NAMES)
def test_nothing_without_the_refit_spans(name):
    from rtbench import devtrace

    w = frame_window()
    bare = devtrace.Window(
        device=w.device, lead=1, tail=1, calls=2,
        host=[x for x in w.host if not x[0].startswith("rtk.re")])
    assert reader(name)(Readings([], [], [bare])) is None
    assert reader(name)(Readings([], [], [frame_window(), bare])) is None
    assert reader(name)(Readings([1.0], [0.5], [])) is None

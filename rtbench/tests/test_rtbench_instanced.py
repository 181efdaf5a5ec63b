"""The `instanced_path` query kind and the `instanced_blob` scene generator
on a tiny instanced cell on the CPU: the generator's world soup is its
affines applied to its BLAS, and its layout is bench.py's; a whole run is
correct and its check reads 0; the plain instanced path tracer in
bfloat16 in the program's place (the control) fails, and so do two broken
programs (the two uniforms swapped; one candidate a ray and no exactness
residual); the boxes' cull of the reference changes no answer; the
instanced trace's span readers on hand-made windows."""
import json
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from rtbench import harness, instanced_path_reference
from rtbench.harness import Readings
from rtbench.loader import load_module
from rtbench.queries import instanced_path
from rtbench.scenes import blob, instanced_blob
from rtbench.tests import tiny

REPO = Path(__file__).resolve().parents[2]
METRICS = REPO / "rtbench" / "metrics"
CELL = "tiny-instanced"
REAL = json.loads((REPO / "rtbench/configs/"
                   "blob6x125-inst-sah8-leaf16-path4.json").read_text())
# The cell's own limits, so that the tiny cell is judged as the real one.
LIMITS = json.loads((REPO / "rtbench/traffic/instanced-path-1024.json")
                    .read_text())["check"]["limits"]
ARGS = dict(REAL["scene"]["args"], subdivisions=2, side=2)  # 8 x 320
CONFIG = dict(REAL, name="tiny-inst-path", triangles=8 * 320,
              instances=8, blas_triangles=320,
              scene=dict(REAL["scene"], args=ARGS),
              query=dict(REAL["query"], max_candidates=3, bounces=3))
TRAFFIC = {
    "kind": "path_primary", "side": 16, "batches": 2, "orbit_deg": 5.0,
    "max_t": 1e30, "bounces": 3,
    "views": [{"eye": [3.0, 2.6, 3.4], "look_at": [0.75, 0.75, 0.75],
               "up": [0, 1, 0], "fov_deg": 45},
              {"eye": [-1.4, 2.6, 3.0], "look_at": [0.75, 0.75, 0.75],
               "up": [0, 1, 0], "fov_deg": 45}],
    "check": {"calls": 2, "rays": 256, "limits": LIMITS}}
SEED = 3_000_000_037


def make_root(tmp):
    root = tiny.make_root(tmp)
    (root / "rtbench/configs/tiny-inst-path.json").write_text(
        json.dumps(CONFIG))
    (root / "rtbench/traffic/tiny-instanced.json").write_text(
        json.dumps(TRAFFIC))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny-inst-path", "source": "test",
                             "file": "rtbench/configs/tiny-inst-path.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": CELL, "config": "tiny-inst-path",
                               "traffic": "tiny-instanced", "chips": 1,
                               "why": "test"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def run(tmp, program=None, log=lambda *_: None):
    return harness.run_cell(make_root(tmp), CELL, SEED, 0.3, False, "cpu",
                            time.perf_counter(), log=log, program=program)


def test_world_soup_is_the_affines_on_the_blas():
    positions, indices, tf = instanced_blob.instances(**ARGS)
    bpos, bidx = blob.make(2, ARGS["seed"], ARGS["displace"])
    assert np.array_equal(positions, bpos) and np.array_equal(indices, bidx)
    wpos, widx = instanced_blob.make(**ARGS)
    assert widx.shape == (8 * 320, 3) and widx.dtype == np.int32
    soup = wpos[widx].reshape(8, 320, 3, 3)
    for i in range(8):
        want = (positions[indices].astype(np.float64) @ tf[i, :, :3].T
                + tf[i, :, 3])
        np.testing.assert_allclose(soup[i], want, rtol=0, atol=1e-6)


def test_layout_is_bench_pys():
    """bench.py::config_instanced's loop, draw for draw, at the real
    configuration's arguments: 125 instances of 81,920 triangles."""
    positions, indices, tf = instanced_blob.instances(
        **REAL["scene"]["args"])
    assert len(indices) * len(tf) == REAL["triangles"] == 10_240_000
    want = np.zeros((125, 3, 4), np.float32)
    rng5 = np.random.default_rng(7)
    for i in range(125):
        gx, gy, gz = i % 5, (i // 5) % 5, i // 25
        sc = 0.35 + 0.15 * rng5.random()
        want[i, :, :3] = np.eye(3, dtype=np.float32) * sc
        want[i, :, 3] = (np.array([gx, gy, gz], np.float32) * 1.1
                         + rng5.random(3).astype(np.float32) * 0.2)
    assert np.array_equal(tf.view(np.int32), want.view(np.int32))


def test_sound_run_reads_zero(tmp_path):
    lines = []
    r = run(tmp_path, log=lines.append)
    assert r["correct"], r["checks"]
    assert {k: v["value"] for k, v in r["checks"].items()} == {
        "radiance_bad_share": 0.0, "radiance_mean_gap": 0.0}
    assert r["attempted"] > 0 and r["failed"] == 0
    assert set(r["metrics"]) == {"mrays_per_s", "call_ms_p95", "setup_s"}
    # notes: one warm call traces 4 times (3 bounces) through the
    # instanced source, a round a candidate at most; no CUDA launch.
    note = next(x for x in lines if x.startswith("one warm call"))
    got = json.loads(note.split(": ", 1)[1])
    assert got["PATH_TRACES"] == got["INSTANCED_TRACES"] == 4
    assert 4 <= got["INSTANCED_ROUNDS"] <= 4 * 3
    assert got["INSTANCED_ROWS"] >= 16 * 16 // 2
    assert got["INSTANCED_SYNCS"] >= 4 * (3 + 1)
    assert got["KERNEL_LAUNCHES"] == got["SHADE_LAUNCHES"] == 0


class Broken(instanced_path.Program):
    fault = None

    def __call__(self, x):
        rays, u = x
        tracer = self.tracer
        if self.fault == "swap":
            u = u.flip(-1).contiguous()
        elif self.fault == "inexact":
            tracer = Inexact(self.pscene)
        return self.path.render_path(tracer, rays, self.materials,
                                     uniforms=u, **self.kw)


class Inexact:
    """The nearest candidate alone, and no residual for the rays it
    cannot prove."""

    def __init__(self, pscene):
        from rtk_tpu_torch import instancing

        self.inst = instancing
        self.pscene = pscene
        self.scene = instancing.InstancedTracer(pscene).scene

    def closest(self, rays, coherent=None):
        return self.inst.trace_closest_instanced_packets(
            self.pscene, rays, max_candidates=1, exact=False)[0]


class Control(instanced_path.Program):
    """The plain instanced path tracer in bfloat16 in the program's
    place."""

    def __init__(self, cell, positions, indices, device):
        super().__init__(cell, positions, indices, device)
        self.cell = cell

    def __call__(self, x):
        rays, u = x
        q = self.cell["config"]["query"]
        kw = {k: v for k, v in instanced_path.settings(q).items()
              if k not in ("compact", "sort_rays")}
        bpos, bidx, tf = instanced_path.instances_of(self.cell)
        return instanced_path_reference.render(
            torch.as_tensor(bpos[bidx]), tf, *instanced_path.material(q),
            rays.origin, rays.direction, rays.min_t, rays.max_t, u, **kw,
            dtype=torch.bfloat16)


@pytest.mark.parametrize("fault", ["swap", "inexact"])
def test_fault_is_not_correct(tmp_path, fault):
    r = run(tmp_path, type("P", (Broken,), {"fault": fault}))
    assert not r["correct"], r["checks"]


def test_control_is_not_correct(tmp_path):
    r = run(tmp_path, Control)
    assert not r["correct"], r["checks"]
    share = r["checks"]["radiance_bad_share"]
    assert share["value"] > 10 * share["limit"]


def test_reference_cull_changes_no_answer():
    """The closest hit with the boxes' cull against every instance tested
    for every ray (boxes grown without end)."""
    positions, indices, tf = instanced_blob.instances(**ARGS)
    soup = torch.as_tensor(positions[indices])
    batch = harness.generate.make(TRAFFIC, SEED, None, "cpu")[0]
    args = [batch[k] for k in ("origin", "direction", "min_t", "max_t")]
    inv = instanced_path_reference.object_from_world(tf)
    culled = instanced_path_reference.closest(
        soup, inv, instanced_path_reference.world_boxes(soup, tf), *args)
    every = instanced_path_reference.closest(
        soup, inv, instanced_path_reference.world_boxes(soup, tf,
                                                        margin=1e6), *args)
    assert int(culled[0].sum()) > 64
    for a, b in zip(culled, every):
        assert torch.equal(a, b)


# ---- the instanced trace's span readers ----

NAMES = ("instanced.candidates_host_ms", "instanced.rounds_host_ms",
         "instanced.idle_pct")


def reader(name):
    return load_module(METRICS / f"{name}.py").read


def frame_window(shift=0.0):
    """Two calls 1000 us apart, each one instanced trace: the slab (100
    us), two rounds (150 us each: a sync, then the rooted trace), then the
    residual (100 us) with its own slab (40 us); device records: the slab
    ends 20 us into the first round, each round's kernel, the residual."""
    from rtbench import devtrace

    device, host = [], []
    for c in range(2):
        t = shift + 1000.0 * c
        host += [("rtbench.call", t, t + 900),
                 ("rtk.path.trace", t + 10, t + 600),
                 ("rtk.instanced.trace", t + 20, t + 520),
                 ("rtk.instanced.candidates", t + 20, t + 120),
                 ("rtk.instanced.round", t + 120, t + 270),
                 ("rtk.packet_trace", t + 180, t + 260),
                 ("rtk.instanced.round", t + 270, t + 420),
                 ("rtk.instanced.residual", t + 420, t + 520),
                 ("rtk.instanced.candidates", t + 430, t + 470),
                 ("rtbench.sync", t + 600, t + 900)]
        device += [("slab", t + 30, t + 140),
                   ("packet_trace_kernel_8", t + 200, t + 300),
                   ("packet_trace_kernel_8", t + 350, t + 430),
                   ("stack", t + 480, t + 620)]
    return devtrace.Window(device=device, host=host, lead=1, tail=1,
                           calls=2)


def test_readers_exact():
    r = Readings([], [], [frame_window(), frame_window(shift=5000.0)])
    assert reader("instanced.candidates_host_ms")(r) == pytest.approx(0.140)
    assert reader("instanced.rounds_host_ms")(r) == pytest.approx(0.300)
    # Each window: 1590 us from its first device record (30) to its last
    # (1620).  Inside a call's instanced trace the card idles 140-200,
    # 300-350 and 430-480 (160 us); between the calls it idles 620-1030,
    # of which 1020-1030 is inside the next call's trace: 330 us a window.
    assert reader("instanced.idle_pct")(r) == pytest.approx(
        100.0 * 330 / 1590)


@pytest.mark.parametrize("name", NAMES)
def test_nothing_without_the_instanced_spans(name):
    from rtbench import devtrace

    w = frame_window()
    bare = devtrace.Window(
        device=w.device, lead=1, tail=1, calls=2,
        host=[x for x in w.host if not x[0].startswith("rtk.instanced.")])
    assert reader(name)(Readings([], [], [bare])) is None
    assert reader(name)(Readings([], [], [frame_window(), bare])) is None
    assert reader(name)(Readings([1.0], [0.5], [])) is None

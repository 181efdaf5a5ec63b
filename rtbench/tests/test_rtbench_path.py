"""The `path` query kind and the `path_primary` traffic kind on a tiny
cell on the CPU: a whole run is correct and its check reads 0, the plain
path tracer in bfloat16 in the program's place (the control) fails, and so
do two broken programs (a bounce fewer, the two uniforms swapped); the
render loop's span readers on hand-made windows."""
import json
import time
from pathlib import Path

import pytest
import torch

from rtbench import harness
from rtbench.harness import Readings
from rtbench.loader import load_module
from rtbench.queries import path
from rtbench.tests import tiny

REPO = Path(__file__).resolve().parents[2]
METRICS = REPO / "rtbench" / "metrics"
# The cell's own limits, so that the tiny cell is judged as the real one.
LIMITS = json.loads((REPO / "rtbench/traffic/atrium-path-1024.json")
                    .read_text())["check"]["limits"]
CELL = "tiny-path"
# A test-only scene generator: a small hall open on two sides (misses take
# the background), one indexed mesh whose triangle k is soup row k, in
# four parts: a bumpy floor, a ceiling (the light), four columns and two
# walls.
HALL = """import numpy as np

from rtbench.scenes.shapes import grid_mesh, icosphere


def make():
    vf, ff = grid_mesh(8, 8, lambda x, z: 0.05 * np.sin(3 * x)
                       * np.cos(2 * z), extent=2.0)
    vc, fc = grid_mesh(8, 8, lambda x, z: 3.0 + 0.1 * np.cos(x), extent=2.0)
    sv, sf = icosphere(1)
    parts = [vf[ff], vc[fc]]
    parts += [(sv * np.float32([0.25, 1.5, 0.25])
               + np.float32([x, 1.5, z]))[sf]
              for x in (-1.0, 1.0) for z in (-1.0, 1.0)]
    vw, fw = grid_mesh(4, 2, None, extent=1.0)
    for sgn in (-1, 1):
        w = vw.copy()
        w[:, 1] = (vw[:, 2] + 1.0) * 1.5
        w[:, 2] = vw[:, 0] * 2.0
        w[:, 0] = sgn * 2.0
        parts.append(w[fw])
    soup = np.concatenate(parts).astype(np.float32)
    n = soup.shape[0]
    return soup.reshape(-1, 3), np.arange(3 * n, dtype=np.int32).reshape(n, 3)
"""
ROWS = (128, 128, 320, 32)
CONFIG = {
    "name": "tiny-hall-path", "scene": {"generator": "test_hall"},
    "triangles": sum(ROWS), "build": tiny.CONFIG["build"],
    "query": {"kind": "path", "bounces": 4, "compact": True,
              "sort_rays": True, "epsilon": 1e-4,
              "background": [0.2, 0.3, 0.4],
              "materials": [
                  {"name": "floor", "rows": ROWS[0],
                   "albedo": [0.7, 0.7, 0.7], "emission": [0, 0, 0]},
                  {"name": "ceiling", "rows": ROWS[1],
                   "albedo": [0, 0, 0], "emission": [4, 4, 4]},
                  {"name": "columns", "rows": ROWS[2],
                   "albedo": [0.6, 0.3, 0.3], "emission": [0, 0, 0]},
                  {"name": "walls", "rows": ROWS[3],
                   "albedo": [0.7, 0.7, 0.7], "emission": [0, 0, 0]}]}}
TRAFFIC = {
    "kind": "path_primary", "side": 32, "batches": 2, "orbit_deg": 5.0,
    "max_t": 1e30, "bounces": 4,
    "views": [{"eye": [0.3, 1.4, 1.8], "look_at": [0, 1, 0],
               "up": [0, 1, 0], "fov_deg": 75},
              {"eye": [-1.5, 0.8, 0.0], "look_at": [1, 1.5, 0.3],
               "up": [0, 1, 0], "fov_deg": 75}],
    "check": {"calls": 2, "rays": 256, "limits": LIMITS}}
SEED = 3_000_000_029


def make_root(tmp):
    root = tiny.make_root(tmp)
    (root / "rtbench/scenes/test_hall.py").write_text(HALL)
    (root / "rtbench/configs/tiny-hall-path.json").write_text(
        json.dumps(CONFIG))
    (root / "rtbench/traffic/tiny-path.json").write_text(json.dumps(TRAFFIC))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny-hall-path", "source": "test",
                             "file": "rtbench/configs/tiny-hall-path.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": CELL, "config": "tiny-hall-path",
                               "traffic": "tiny-path", "chips": 1,
                               "why": "test"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def run(tmp, program=None, trace=False):
    return harness.run_cell(make_root(tmp), CELL, SEED, 0.3, trace, "cpu",
                            time.perf_counter(), log=lambda *_: None,
                            program=program)


def test_sound_run_reads_zero(tmp_path):
    lines = []
    r = harness.run_cell(make_root(tmp_path), CELL, SEED, 0.3, False, "cpu",
                         time.perf_counter(), log=lines.append)
    assert r["correct"], r["checks"]
    assert {k: v["value"] for k, v in r["checks"].items()} == {
        "radiance_bad_share": 0.0, "radiance_mean_gap": 0.0}
    assert r["attempted"] > 0 and r["failed"] == 0
    assert set(r["metrics"]) == {"mrays_per_s", "call_ms_p95", "setup_s"}
    # notes: the counters of one warm call, 5 traces and 4 syncs.
    note = next(x for x in lines if x.startswith("one warm call"))
    got = json.loads(note.split(": ", 1)[1])
    assert got["PATH_TRACES"] == 5 and got["PATH_SYNCS"] == 4
    assert 32 * 32 < got["PATH_ROWS"] <= 5 * 32 * 32


def test_traffic_carries_uniforms_by_seed(tmp_path):
    from rtbench.traffic import generate

    root = make_root(tmp_path)
    kinds = root / "rtbench/traffic/kinds"
    a = generate.make(TRAFFIC, SEED, None, "cpu", kinds)
    b = generate.make(TRAFFIC, SEED, None, "cpu", kinds)
    c = generate.make(TRAFFIC, SEED + 1, None, "cpu", kinds)
    assert len(a) == 2
    for x, y, z in zip(a, b, c):
        u = x["uniforms"]
        assert u.shape == (4, 32 * 32, 2) and u.dtype == torch.float32
        assert float(u.min()) >= 0.0 and float(u.max()) < 1.0
        assert torch.equal(u, y["uniforms"])
        assert not torch.equal(u, z["uniforms"])
    assert not torch.equal(a[0]["uniforms"], a[1]["uniforms"])


class Broken(path.Program):
    fault = None

    def __call__(self, x):
        rays, u = x
        kw = dict(self.kw)
        if self.fault == "bounce":
            kw["bounces"] -= 1
        elif self.fault == "swap":
            u = u.flip(-1).contiguous()
        return self.path.render_path(self.tracer, rays, self.materials,
                                     uniforms=u, **kw)


class Control(path.Program):
    """The plain path tracer in bfloat16 in the program's place."""

    def __init__(self, cell, positions, indices, device):
        super().__init__(cell, positions, indices, device)
        self.cell = cell
        self.soup = torch.as_tensor(positions[indices], device=device)

    def __call__(self, x):
        rays, u = x
        q = self.cell["config"]["query"]
        kw = {k: v for k, v in path.settings(q).items()
              if k not in ("compact", "sort_rays")}
        material = path.path_reference.material_of_rows(
            [m["rows"] for m in q["materials"]], self.soup.device)
        return path.path_reference.render(
            self.soup, material, [m["albedo"] for m in q["materials"]],
            [m["emission"] for m in q["materials"]], rays.origin,
            rays.direction, rays.min_t, rays.max_t, u, **kw,
            dtype=torch.bfloat16)


@pytest.mark.parametrize("fault", ["bounce", "swap"])
def test_fault_is_not_correct(tmp_path, fault):
    r = run(tmp_path, type("P", (Broken,), {"fault": fault}))
    assert not r["correct"], r["checks"]


def test_control_is_not_correct(tmp_path):
    r = run(tmp_path, Control)
    assert not r["correct"], r["checks"]
    share = r["checks"]["radiance_bad_share"]
    assert share["value"] > 10 * share["limit"]


def test_calibrate_reads_program_and_control(tmp_path):
    from rtbench import calibrate

    root = make_root(tmp_path)
    out = tmp_path / "cal.jsonl"
    calibrate.main(["--workload", CELL, "--seeds", "8", "9", "--seconds",
                    "0.2", "--device", "cpu", "--out", str(out)], root=root)
    for line in map(json.loads, out.read_text().splitlines()):
        assert all(line["program"][k] <= LIMITS[k] for k in LIMITS)
        assert any(line["control_bf16"][k] > LIMITS[k] for k in LIMITS)
        assert line["program"]["radiance_mean_ref"] > 0


# ---- the render loop's span readers ----

NAMES = ("path.trace_host_ms", "path.shade_host_ms", "path.compact_host_ms",
         "path.idle_pct")


def reader(name):
    return load_module(METRICS / f"{name}.py").read


def frame_window(shift=0.0):
    """Two calls 1000 us apart, each of three bounces: a trace (the
    Tracer's span inside), a shade and a compact, twice, then the last
    trace and shade; a device record for each trace and each shade."""
    from rtbench import devtrace

    device, host = [], []
    for c in range(2):
        t = shift + 1000.0 * c
        host += [("rtbench.call", t, t + 900),
                 ("rtk.path.render", t + 10, t + 890)]
        at = t + 20
        for bounce in range(3):
            host += [("rtk.path.trace", at, at + 100),
                     ("rtk.tracer.closest", at + 10, at + 90),
                     ("rtk.path.shade", at + 100, at + 150)]
            device += [("packet_trace_kernel_8", at + 80, at + 160),
                       ("elementwise_kernel", at + 170, at + 200)]
            if bounce < 2:
                host += [("rtk.path.compact", at + 150, at + 220)]
            at += 250
        host += [("rtbench.sync", t + 890, t + 900)]
    return devtrace.Window(device=device, host=host, lead=1, tail=1,
                           calls=2)


def test_readers_exact():
    r = Readings([], [], [frame_window(), frame_window(shift=5000.0)])
    assert reader("path.trace_host_ms")(r) == pytest.approx(0.300)
    assert reader("path.shade_host_ms")(r) == pytest.approx(0.150)
    assert reader("path.compact_host_ms")(r) == pytest.approx(0.140)
    # Each window: 1620 us from its first device record (100) to its
    # last (1720).  A bounce's card idles 10 us between its two records
    # and, after the first two bounces, 130 us more (to the next trace's
    # kernel); the host is in the shade or the compact for 10 + 20 of them
    # (a compact ends 20 us after its bounce's last record), and for none
    # of the last bounce's: 60 us a call.
    assert reader("path.idle_pct")(r) == pytest.approx(100.0 * 120 / 1620)


@pytest.mark.parametrize("name", NAMES)
def test_nothing_without_the_path_spans(name):
    from rtbench import devtrace

    w = frame_window()
    bare = devtrace.Window(
        device=w.device, lead=1, tail=1, calls=2,
        host=[x for x in w.host if not x[0].startswith("rtk.path.")])
    assert reader(name)(Readings([], [], [bare])) is None
    assert reader(name)(Readings([], [], [frame_window(), bare])) is None
    assert reader(name)(Readings([1.0], [0.5], [])) is None

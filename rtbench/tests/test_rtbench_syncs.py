"""The readers of the instanced round's stages and of the host syncs in
both wavefront loops (rtbench/syncs.py) on hand-made windows: exact
values, nested spans counted once, syncs outside the spans they read left
out, and nothing where a window holds no span of the reader's layer; on
the card, the sync readers' counts against the program's counters."""
from pathlib import Path

import numpy as np
import pytest
import torch

from rtbench import devtrace, syncs
from rtbench.harness import Readings
from rtbench.loader import load_module

METRICS = Path(__file__).resolve().parents[1] / "metrics"
STAGES = ("instanced.live_host_ms", "instanced.rays_host_ms",
          "instanced.scatter_host_ms")
INSTANCED = ("instanced.round_trace_host_ms", "instanced.syncs",
             "instanced.sync_wait_ms")
SYNC = "cudaStreamSynchronize"


def reader(name):
    return load_module(METRICS / f"{name}.py").read


def frame_window(shift=0.0, stages=True):
    """Two instanced frames 1000 us apart, each with a launched round and
    an empty one, a residual, a shade and a compacted bounce, and the
    runtime's records inside and outside them; stages=False leaves out
    the round's stage spans, as a program without them gives."""
    device, host = [], []
    for c in range(2):
        t = shift + 1000.0 * c
        device += [("packet_trace_kernel_8", t + 160, t + 190),
                   ("shade_sample", t + 560, t + 590)]
        host += [("rtbench.call", t, t + 900),
                 ("rtk.path.render", t + 5, t + 890),
                 ("rtk.path.trace", t + 10, t + 500),
                 ("rtk.instanced.trace", t + 20, t + 480),
                 ("rtk.instanced.candidates", t + 25, t + 40),
                 ("rtk.instanced.round", t + 50, t + 300),
                 ("rtk.packet_trace", t + 125, t + 200),
                 ("cudaLaunchKernel", t + 150, t + 155),
                 ("rtk.instanced.round", t + 310, t + 340),
                 ("rtk.instanced.residual", t + 350, t + 470),
                 (SYNC, t + 60, t + 68),  # the live count
                 (SYNC, t + 220, t + 230),  # two of the scatter's masks
                 (SYNC, t + 240, t + 245),
                 (SYNC, t + 320, t + 330),  # the empty round's live count
                 (SYNC, t + 360, t + 364),  # the residual's count
                 ("rtk.packet_trace", t + 505, t + 520),  # not in a round
                 ("rtk.path.shade", t + 530, t + 600),
                 (SYNC, t + 550, t + 555),  # in no span that is read
                 ("rtk.path.compact", t + 610, t + 700),
                 ("cudaMemcpyAsync", t + 615, t + 619),
                 (SYNC, t + 620, t + 680),  # the bounce's live count
                 ("rtbench.sync", t + 900, t + 950),
                 ("cudaDeviceSynchronize", t + 901, t + 949)]
        if stages:
            host += [("rtk.instanced.live", t + 50, t + 70),
                     ("rtk.instanced.rays", t + 75, t + 120),
                     ("rtk.instanced.scatter", t + 210, t + 295),
                     ("rtk.instanced.live", t + 310, t + 335)]
    return devtrace.Window(device=device, host=host, lead=1, tail=1,
                           calls=2)


def readings(*windows):
    return Readings([], [], list(windows))


def test_readers_exact():
    r = readings(frame_window(), frame_window(shift=5000.0))
    got = {name: reader(name)(r) for name in
           STAGES + INSTANCED + ("path.sync_wait_ms",)}
    assert got == pytest.approx({
        "instanced.live_host_ms": 0.045, "instanced.rays_host_ms": 0.045,
        "instanced.scatter_host_ms": 0.085,
        "instanced.round_trace_host_ms": 0.075,
        "instanced.syncs": 5.0, "instanced.sync_wait_ms": 0.037,
        "path.sync_wait_ms": 0.060})


def test_nested_spans_count_once():
    w = frame_window()
    for c in range(2):
        t = 1000.0 * c
        w.host += [("rtk.instanced.live", t + 52, t + 69),
                   ("rtk.packet_trace", t + 130, t + 190),
                   ("rtk.instanced.round", t + 55, t + 250),
                   ("rtk.path.compact", t + 612, t + 690)]
    r = readings(w)
    assert reader("instanced.live_host_ms")(r) == pytest.approx(0.045)
    assert reader("instanced.round_trace_host_ms")(r) == pytest.approx(0.075)
    assert reader("instanced.syncs")(r) == pytest.approx(5.0)
    assert reader("instanced.sync_wait_ms")(r) == pytest.approx(0.037)
    assert reader("path.sync_wait_ms")(r) == pytest.approx(0.060)


def test_syncs_outside_the_spans_not_counted():
    w = frame_window()
    for c in range(2):
        t = 1000.0 * c
        # Straddling the instanced trace's end and the compaction's
        # start, before the frame, in the shade, in the benchmark's own
        # sync, and another runtime call inside a round.
        w.host += [(SYNC, t + 475, t + 485), (SYNC, t + 1, t + 4),
                   (SYNC, t + 580, t + 590), (SYNC, t + 905, t + 910),
                   (SYNC, t + 605, t + 612), ("cudaMemcpyAsync", t + 80,
                                              t + 90)]
    r = readings(w)
    assert reader("instanced.syncs")(r) == pytest.approx(5.0)
    assert reader("instanced.sync_wait_ms")(r) == pytest.approx(0.037)
    assert reader("path.sync_wait_ms")(r) == pytest.approx(0.060)


def test_nothing_without_the_spans():
    w = frame_window()
    bare = devtrace.Window(device=w.device, lead=1, tail=1, calls=2,
                           host=[x for x in w.host
                                 if not x[0].startswith("rtk.")])
    for name in STAGES + INSTANCED + ("path.sync_wait_ms",):
        assert reader(name)(readings(bare)) is None, name
        assert reader(name)(readings(frame_window(), bare)) is None, name
        assert reader(name)(Readings([1.0], [0.5], [])) is None, name
    # A program without the stage spans: the stages read nothing, the
    # round's trace and syncs read as before.
    old = readings(frame_window(stages=False))
    assert all(reader(name)(old) is None for name in STAGES)
    assert reader("instanced.syncs")(old) == pytest.approx(5.0)
    assert reader("instanced.round_trace_host_ms")(old) == pytest.approx(
        0.075)
    # The path cell: no instanced span, the compaction's syncs read.
    path = devtrace.Window(device=w.device, lead=1, tail=1, calls=2,
                           host=[x for x in w.host
                                 if not x[0].startswith("rtk.instanced")])
    assert reader("instanced.syncs")(readings(path)) is None
    assert reader("path.sync_wait_ms")(readings(path)) == pytest.approx(
        0.060)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_sync_readers_match_the_counters(cuda):
    """Profiled frames of render_path over four instances (every instance
    a candidate, so the residual re-traces nothing): the runtime's sync
    records inside the instanced spans and inside the compaction equal
    the syncs INSTANCED_SYNCS and PATH_SYNCS count a frame."""
    import rtk_tpu_torch as rt
    from rtk_tpu_torch import instancing
    from rtk_tpu_torch.models import path
    from rtk_tpu_torch.testing import scenes

    v, f = scenes.icosphere(2)
    blas = rt.build_from_soup(v[f].astype(np.float32), device=cuda,
                              config=rt.BuildConfig(leaf_size=8))
    tf = np.zeros((4, 3, 4), np.float32)
    tf[:, :, :3] = np.eye(3) * 0.4
    tf[:, :, 3] = [(-0.5, 0, 0), (0.5, 0, 0), (0, 0.5, -0.3), (0, -0.5, 0.3)]
    ps = rt.pack_instanced(rt.build_instanced([blas], np.zeros(4), tf))
    tracer = instancing.InstancedTracer(ps, max_candidates=4)
    rays = scenes.camera_rays((0.3, 0.4, 2.5), (0, 0, 0), (0, 1, 0), 50,
                              128, 128, order="morton", device=cuda)
    mats = path.Materials.make([[0.7, 0.6, 0.5]], [[0.0, 0.0, 0.0]],
                               device=cuda)
    u = torch.rand((2, rays.count, 2), device=cuda,
                   generator=torch.Generator(device=cuda).manual_seed(1))

    def frame():
        path.render_path(tracer, rays, mats, bounces=2, uniforms=u)

    frame()
    torch.cuda.synchronize()
    before = instancing.INSTANCED_SYNCS, path.PATH_SYNCS
    res = instancing.INSTANCED_RESIDUAL
    w = devtrace.record(frame, 2)
    counted = (instancing.INSTANCED_SYNCS - before[0],
               path.PATH_SYNCS - before[1])
    assert instancing.INSTANCED_RESIDUAL == res
    r = readings(w)
    assert counted[0] > 3 * 5 and counted[1] == 2 * 2
    assert reader("instanced.syncs")(r) == counted[0] / 2
    assert syncs.syncs(r, "rtk.path.compact", "rtk.path.") == counted[1] / 2
    assert reader("instanced.sync_wait_ms")(r) > 0
    assert reader("path.sync_wait_ms")(r) > 0

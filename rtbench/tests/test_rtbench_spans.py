"""The readers of the program's spans on hand-made windows (exact values,
and nothing where a window holds no span of the program), and on the
card: the program's spans stay off the device's records and share the
device's clock."""
from pathlib import Path

import pytest
import torch

from rtbench import devtrace
from rtbench.harness import Readings
from rtbench.loader import load_module

METRICS = Path(__file__).resolve().parents[1] / "metrics"
NAMES = ("packet_trace.host_ms", "hits.host_ms", "kernel.launch_us",
         "device.idle_pct.program")


def reader(name):
    return load_module(METRICS / f"{name}.py").read


def call_window(shift=0.0):
    """Two calls 200 us apart: device records, the benchmark's spans and
    the program's (a call's root, front end, launch and two field
    reads)."""
    device, host = [], []
    for c in range(2):
        t = shift + 200.0 * c
        device += [("k_key", t + 100, t + 110),
                   ("packet_trace_kernel_8", t + 130, t + 160)]
        host += [("rtbench.call", t, t + 195),
                 ("rtk.tracer.closest", t + 10, t + 170),
                 ("rtk.packet_trace", t + 20, t + 150),
                 ("aten::sort", t + 30, t + 40),
                 ("rtk.packet_trace.launch", t + 115, t + 128),
                 ("rtk.hits.triangle_index", t + 172, t + 180),
                 ("rtk.hits.mesh_index", t + 182, t + 190),
                 ("rtbench.sync", t + 195, t + 199)]
    return devtrace.Window(device=device, host=host, lead=1, tail=1,
                           calls=2)


def test_readers_exact():
    r = Readings([], [], [call_window(), call_window(shift=1000.0)])
    assert reader("packet_trace.host_ms")(r) == pytest.approx(0.130)
    assert reader("hits.host_ms")(r) == pytest.approx(0.016)
    assert reader("kernel.launch_us")(r) == pytest.approx(13.0)
    # Each window: 260 us from its first device record to its last, 180
    # of them idle; of those, 156 while the host is in a span of the
    # program (20 in the front end, 10 + 8 + 8 + 90 between the calls,
    # 20 in the second front end).
    assert reader("device.idle_pct.program")(r) == pytest.approx(60.0)
    assert r.idle_pct() == pytest.approx(100.0 * 180 / 260)


def test_nested_spans_count_once():
    w = call_window()
    w.host.append(("rtk.packet_trace", 25, 140))
    r = Readings([], [], [w])
    assert reader("packet_trace.host_ms")(r) == pytest.approx(0.130)


def test_idle_gaps_name_the_program():
    gaps = dict(devtrace.idle_gaps([call_window()]))
    # 110-130 in the front end, 160-300 in the root's end and then the
    # benchmark's call, 310-330 in the second front end.
    assert gaps == pytest.approx({"rtk.packet_trace": 40e-6,
                                  "rtk.tracer.closest": 140e-6})


@pytest.mark.parametrize("name", NAMES)
def test_nothing_without_the_program_spans(name):
    w = call_window()
    bare = devtrace.Window(
        device=w.device, lead=1, tail=1, calls=2,
        host=[x for x in w.host if not x[0].startswith("rtk.")])
    assert reader(name)(Readings([], [], [bare])) is None
    assert reader(name)(Readings([], [], [call_window(), bare])) is None
    assert reader(name)(Readings([1.0], [0.5], [])) is None


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_spans_on_the_card(cuda):
    import rtk_tpu_torch as rt
    from rtk_tpu_torch.ops import packet_trace as pt
    from rtk_tpu_torch.testing import scenes

    v, f = scenes.blob(4)[1:]
    tracer = rt.Tracer(rt.build_scene((v, f), device=cuda))
    rays = scenes.camera_rays((0, 0, 3.0), (0, 0, 0), (0, 1, 0), 45, 128,
                              128, device=cuda)
    assert rays.count >= pt.SORT_RAYS_MIN

    def call():
        h = tracer.closest(rays)
        return h.triangle_index, h.mesh_index

    call()
    torch.cuda.synchronize()
    # The spans draw no range on the card's timeline at all (user
    # annotations included), so no reader of device records sees them.
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        call()
        torch.cuda.synchronize()
    on_card = [e.name for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    assert on_card and not any(n.startswith("rtk.") for n in on_card)
    calls = 4
    windows = devtrace.clean_windows(call, calls)
    for w in windows:
        assert not any(n.startswith("rtk.") for n, _, _ in w.device)
        names = [n for n, _, _ in w.host]
        assert names.count("rtk.tracer.closest") == calls
        assert names.count("rtk.packet_trace.sort") == calls
        launches = sorted(s for n, s, _ in w.host
                          if n == "rtk.packet_trace.launch")
        kernels = sorted(s for n, s, _ in w.device
                         if devtrace.TRAVERSAL_KERNEL in n)
        assert len(launches) == len(kernels) == calls
        assert all(k > s for s, k in zip(launches, kernels))
    r = Readings([], [], windows)
    got = {name: reader(name)(r) for name in NAMES}
    assert all(v is not None and v > 0 for v in got.values()), got
    assert got["device.idle_pct.program"] <= r.idle_pct()

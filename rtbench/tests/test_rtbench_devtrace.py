"""The trace reduction on synthetic records: spins are left out and
counted, a window is clean only with a spin on each side of the calls,
busy time is a union, idle gaps are named by the host's record."""
from rtbench import devtrace

SPIN = "void at::native::spin_kernel(long)"


def spins(t0, n):
    return [(SPIN, t0 + i, t0 + i + 0.5) for i in range(n)]


def test_clean_window_needs_a_spin_on_each_side():
    calls = [("k_a", 100, 110), ("k_b", 108, 120), ("k_c", 130, 131)]
    span = [("rtbench.call", 99, 140)]
    w = devtrace.split_spins(spins(0, 5) + span + calls + spins(200, 3),
                             calls=2)
    assert (w.lead, w.tail, w.clean) == (5, 3, True)
    assert w.device == calls
    lost_tail = devtrace.split_spins(spins(0, 5) + calls, calls=2)
    assert not lost_tail.clean
    lost_all = devtrace.split_spins(spins(0, 5) + spins(200, 3), calls=2)
    assert not lost_all.clean and lost_all.device == []


def test_busy_is_the_union():
    w = devtrace.Window(device=[("a", 0, 10), ("b", 5, 12), ("c", 20, 25)],
                        host=[], lead=1, tail=1, calls=1)
    assert devtrace.busy_intervals(w.device) == [[0, 12], [20, 25]]
    assert devtrace.busy_window_us(w) == (17, 25)


def test_device_ops_and_idle_gaps():
    w = devtrace.Window(
        device=[("k", 0, 10), ("k", 20, 30), ("m", 40, 41)],
        host=[("rtbench.call", 0, 100), ("aten::sort", 9, 25),
              ("cudaLaunchKernel", 35, 36)],
        lead=1, tail=1, calls=1)
    assert devtrace.device_ops([w]) == [("k", 20e-6), ("m", 1e-6)]
    # The gap at 10 lies in aten::sort (the shortest cover), the gap at 30
    # in the call alone.
    assert devtrace.idle_gaps([w]) == [("aten::sort", 10e-6),
                                       ("rtbench.call", 10e-6)]
    bare = devtrace.Window(device=w.device, host=[], lead=1, tail=1, calls=1)
    assert devtrace.idle_gaps([bare]) == [("host: no record", 20e-6)]

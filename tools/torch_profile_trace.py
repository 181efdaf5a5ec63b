"""Isolate the trace path's costs on the card: the fixed cost of one
launch, the raw kernel, and the full trace without and with the coherence
sort.

    python3 tools/torch_profile_trace.py

The counterpart of tools/profile_trace.py for rtk_tpu_torch.  Run it from
the repository's root on a machine with one CUDA card; it needs only the
committed files (nvcc builds both kernel libraries into
rtk_tpu_torch/build/ at first use) and takes well under a minute.

Scene: blob(6) (81,920 triangles), build_from_soup with BuildConfig(
branching=8, leaf_size=8), pack_scene; rays: 1024^2 Morton-ordered
primaries from (0, 0, 3), fov 45.  Stages:
  (a) dispatch_probe: csrc/dispatch_probe.cu's o = x + 1 on an (8, 128)
      f32 tensor through this package's ctypes binding (the path every
      kernel of the port takes), beside one eager x + 1.0;
  (b) the traversal kernel alone (ops/packet_trace.py::packet_trace) on
      rows stacked once outside the timed loop;
  (c) trace_packets(..., sort_rays=False);
  (d) trace_packets(..., sort_rays=True).
Each stage is timed by timeit(): the pipelined issue rate of back-to-back
calls, not one call's latency.  It prints ms and Mrays/s a stage, the
probe's build seconds, and the card's name and power limit.  Needs a CUDA
device; imports no jax.
"""
import ctypes
import os
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:  # run as a script: the package is one level up
    sys.path.insert(0, REPO)

import rtk_tpu_torch as rt  # noqa: E402
from rtk_tpu_torch.ops import library  # noqa: E402
from rtk_tpu_torch.ops import packet_trace as pt  # noqa: E402
from rtk_tpu_torch.testing import scenes  # noqa: E402
from rtk_tpu_torch.trace.packed import pack_scene  # noqa: E402
from rtk_tpu_torch.utils.build import build_shared  # noqa: E402

PROBE_SRC = os.path.join(REPO, "rtk_tpu_torch", "csrc", "dispatch_probe.cu")
PROBE_SHAPE = (8, 128)  # the JAX tool's block
CAM = dict(eye=(0, 0, 3.0), look_at=(0, 0, 0), up=(0, 1, 0), fov_deg=45)
SIDE = 1024

# Launches of the probe kernel in this process; a run resets and reads it.
PROBE_LAUNCHES = 0
# Seconds of the probe library's build and load in this process (None:
# not built yet).
BUILD_SECONDS = None
_lib = None


def probe_library():
    """Build (at first use, keyed on the source hash, with the traversal
    kernel's NVCC_FLAGS) and load the probe's library.  Raises if nvcc is
    missing or the build fails.  Needs nvcc, not a card."""
    global _lib, BUILD_SECONDS
    if _lib is None:
        t0 = time.perf_counter()
        so, _ = build_shared("dispatch_probe", [PROBE_SRC],
                             [library._nvcc(), *library.NVCC_FLAGS])
        lib = ctypes.CDLL(str(so))
        lib.rtk_dispatch_probe.restype = ctypes.c_int
        lib.rtk_dispatch_probe.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                           ctypes.c_int, ctypes.c_void_p]
        _lib, BUILD_SECONDS = lib, time.perf_counter() - t0
    return _lib


def dispatch_probe_reference(x):
    """The probe's plain version: x + 1.0, one eager op."""
    return x + 1.0


def dispatch_probe(x):
    """x + 1 over a float32 tensor: on a CUDA tensor the probe kernel,
    launched on the current stream of x's device as ops/packet_trace.py::
    _launch launches the traversal kernel; on a CPU tensor the plain
    version.  Raises on a launch error."""
    global PROBE_LAUNCHES
    if x.dtype != torch.float32:
        raise ValueError(f"dispatch_probe takes float32, not {x.dtype}")
    if not x.is_cuda:
        if x.device.type != "cpu":
            raise ValueError(f"no dispatch probe for device {x.device}")
        return dispatch_probe_reference(x)
    if x.numel() > 2 ** 31 - 1:
        raise ValueError(f"{x.numel()} values exceed the kernel's int index")
    x = x.contiguous()
    lib = probe_library()
    out = torch.empty_like(x)
    if not x.numel():
        return out
    dev = x.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.rtk_dispatch_probe(x.data_ptr(), out.data_ptr(), x.numel(),
                                     stream)
    if err != 0:
        raise RuntimeError(f"dispatch_probe launch failed: CUDA error {err}")
    PROBE_LAUNCHES += 1
    return out


def probe_input(seed=0):
    """An (8, 128) f32 array from `seed` that holds what an add can get
    wrong: +-0, +-inf, NaNs of both signs, subnormals of both signs, the
    largest finite values, and values near 2^24 where x + 1 rounds to an
    even neighbour; the rest normal values over the whole exponent
    range."""
    rng = np.random.default_rng(seed)
    n = PROBE_SHAPE[0] * PROBE_SHAPE[1]
    special = np.array([
        0.0, -0.0, np.inf, -np.inf, np.nan, -np.nan, 1e-45, -1e-45,
        1.1754942e-38, -1.1754942e-38, 1.1754944e-38, 16777215.0,
        16777216.0, 16777218.0, 16777220.0, -16777216.0, -16777218.0,
        8388607.5, 0.99999994, -0.99999994, -1.0, 3.4028235e38,
        -3.4028235e38], np.float32)
    sub = ((rng.integers(1, 1 << 23, 256, dtype=np.int64)
            | (rng.integers(0, 2, 256, dtype=np.int64) << 31))
           .astype(np.uint32).view(np.float32))
    near = ((rng.integers(-512, 512, 256) + (1 << 24))
            * rng.choice([-1.0, 1.0], 256)).astype(np.float32)
    rest = n - special.size - sub.size - near.size
    wide = (rng.standard_normal(rest)
            * 10.0 ** rng.uniform(-37, 37, rest)).astype(np.float32)
    x = np.concatenate([special, sub, near, wide])
    return x[rng.permutation(n)].reshape(PROBE_SHAPE)


def timeit(fn, iters=5, batches=3):
    """Seconds a call of fn at the pipelined issue rate: the best over
    `batches` of the mean over `iters` back-to-back calls followed by one
    torch.cuda.synchronize() (profile_trace.py:14-25).  The card's work
    overlaps the host's issue of the next call, so this is not a call's
    latency."""
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(batches):
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        best = min(best, (time.perf_counter() - t0) / iters)
    return best


def build_packed(device, subdivisions=6):
    """The tool's scene: blob(subdivisions), BuildConfig(8, 8), packed."""
    cfg = rt.BuildConfig(branching=8, leaf_size=8)
    tris = scenes.blob(subdivisions=subdivisions)[0]
    return pack_scene(rt.build_from_soup(tris, config=cfg, device=device))


def camera(device, side=SIDE):
    """side^2 Morton-ordered primaries from (0, 0, 3), fov 45."""
    return scenes.camera_rays(**CAM, width=side, height=side, order="morton",
                              device=device)


def probe_stages(device):
    """Stage (a): {"probe", "eager"} callables on an (8, 128) f32 zero
    tensor on `device`."""
    x = torch.zeros(PROBE_SHAPE, dtype=torch.float32, device=device)
    return {"probe": lambda: dispatch_probe(x),
            "eager": lambda: dispatch_probe_reference(x)}


def trace_stages(packed, rays):
    """Stages (b) to (d) -> {"raw_kernel", "trace_unsorted",
    "trace_sorted"} callables.  raw_kernel returns the traversal's (t, u,
    v, slot) over the rays' (8, N) rows, stacked once here in the caller's
    order; the others return PacketHits."""
    rows, _ = pt._ray_rows(pt.front_steps(rays.device), rays, False)
    kw = dict(leaf_size=packed.leaf_size, stack_size=packed.stack_size)
    return {
        "raw_kernel": lambda: pt.packet_trace(packed.nodes, packed.tris, rows,
                                              **kw),
        "trace_unsorted": lambda: pt.trace_packets(packed, rays,
                                                   sort_rays=False),
        "trace_sorted": lambda: pt.trace_packets(packed, rays,
                                                 sort_rays=True)}


def main():
    if not torch.cuda.is_available():
        raise SystemExit("torch_profile_trace.py needs a CUDA device")
    dev = torch.device("cuda")
    print(f"device: {torch.cuda.get_device_name(0)}", flush=True)
    probe_library()
    print(f"dispatch_probe build: {BUILD_SECONDS:.2f} s", flush=True)
    for name, fn in probe_stages(dev).items():
        dt = timeit(fn, iters=10)
        print(f"(a) trivial {name} dispatch: {dt * 1e6:.2f} us a call "
              "(pipelined issue rate)", flush=True)
    packed = build_packed(dev)
    rays = camera(dev)
    n = rays.count
    for name, fn in trace_stages(packed, rays).items():
        dt = timeit(fn)
        print(f"{name}: {dt * 1e3:.3f} ms -> {n / dt / 1e6:.2f} Mrays/s",
              flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())

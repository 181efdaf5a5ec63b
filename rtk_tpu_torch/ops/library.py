"""The port's CUDA library: its sources, its nvcc build, its ctypes
binding and the launch of its entry points, each a C function that takes
the stream last and returns a CUDA error code.  The wrappers that check
tensors and count launches are their callers' (ops/packet_trace.py,
models/path.py, scene.py, trace/packed.py, instancing.py)."""
from __future__ import annotations

import ctypes
import os
import shutil
import time

import torch

from rtk_tpu_torch.ops.filter_capture import JitFilter
from rtk_tpu_torch.utils.build import BUILD_DIR, PKG_ROOT, build_shared

CSRC = PKG_ROOT / "csrc"
KERNEL_SRC = CSRC / "packet_trace.cu"
# The sorted front end's kernels, in one library with the traversal so
# that a caller with one loaded library (utils/aot.py's artifacts) has
# the whole front end.
KEY_SRC = CSRC / "coherence_key.cu"
ROWS_SRC = CSRC / "ray_rows.cu"
UNSORT_SRC = CSRC / "unsort.cu"
# render_path's shade pass (models/path.py::shade_kernel), in the same
# library so that one build and one load serve the whole render loop.
SHADE_SRC = CSRC / "shade.cu"
# A deforming frame's refit and repack (scene.py::refit_kernel,
# trace/packed.py::repack_kernel), so that an AOT refit artifact carries
# them too.
REFIT_SRC = CSRC / "refit.cu"
# The instance candidate slab (instancing.py::candidates_kernel).
CANDIDATES_SRC = CSRC / "candidates.cu"
# An instanced candidate round's object rays and hit scatter
# (instancing.py::round_rays_kernel, round_scatter_kernel).
ROUNDS_SRC = CSRC / "rounds.cu"
LIBRARY_SRCS = [KERNEL_SRC, KEY_SRC, ROWS_SRC, UNSORT_SRC, SHADE_SRC,
                REFIT_SRC, CANDIDATES_SRC, ROUNDS_SRC]
FILTER_OPS = CSRC / "filter_ops.h"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

# Loaded kernel libraries by filter key (None: the build without a
# filter), the compiler output (ptxas -v) and seconds of each build made
# by this process.
_libs: dict = {}
BUILD_LOGS: dict = {}
BUILD_SECONDS: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return os.path.join(home, "bin", "nvcc")


def kernel_library(flt: JitFilter | None = None):
    """Build the kernel library for `flt` (None: the build without a
    filter) if it is not built yet, keyed on the hash of its sources ->
    (path of the .so, compiler output; empty when it was built already).
    Needs nvcc, not a card."""
    if flt is None:
        return build_shared("packet_trace", LIBRARY_SRCS,
                            [_nvcc(), *NVCC_FLAGS])
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    header = BUILD_DIR / f"filter-{flt.key}.h"
    if not header.exists() or header.read_text() != flt.source:
        tmp = header.with_name(f"{header.name}.tmp{os.getpid()}")
        tmp.write_text(flt.source)
        os.replace(tmp, header)
    return build_shared(
        "packet_trace_filter", LIBRARY_SRCS,
        [_nvcc(), *NVCC_FLAGS, "-DRTK_FILTER", f"-I{CSRC}",
         "-include", str(header)], deps=[FILTER_OPS, header])


def bind_library(path, march: bool):
    """Load a kernel library with ctypes and declare its entry points;
    march: the library is a build without a filter, which also holds the
    march instantiation."""
    lib = ctypes.CDLL(str(path))
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.rtk_packet_trace.restype = i32
    lib.rtk_packet_trace.argtypes = [ptr] * 5 + [i32] * 8 + [ptr] * 6
    lib.rtk_packet_trace_max_stack.restype = i32
    lib.rtk_packet_trace_max_stack.argtypes = []
    i64 = ctypes.c_longlong
    lib.rtk_coherence_key.restype = i32
    lib.rtk_coherence_key.argtypes = ([ptr] + [i64] * 2 + [ptr] + [i64] * 3
                                      + [ptr] * 3)
    lib.rtk_ray_rows.restype = i32
    lib.rtk_ray_rows.argtypes = ([ptr, i64] + [ptr, i64, i64] * 2
                                 + [ptr, i64] * 2 + [ptr] * 2)
    lib.rtk_unsort.restype = i32
    lib.rtk_unsort.argtypes = [ptr, i64] + [ptr] * 11
    lib.rtk_shade.restype = i32
    lib.rtk_shade.argtypes = [ptr, ptr]
    lib.rtk_instance_candidates.restype = i32
    lib.rtk_instance_candidates.argtypes = ([ptr, ptr, i32] + [ptr] * 4
                                            + [i64, i32] + [ptr] * 4)
    lib.rtk_instanced_round_rays.restype = i32
    lib.rtk_instanced_round_rays.argtypes = [ptr, ptr, i64] + [ptr] * 14
    lib.rtk_instanced_round_scatter.restype = i32
    lib.rtk_instanced_round_scatter.argtypes = [ptr, i64] + [ptr] * 13
    declare_refit(lib)
    if march:
        lib.rtk_packet_march.restype = i32
        lib.rtk_packet_march.argtypes = ([ptr] * 3 + [i32] * 9 + [f32] * 9
                                         + [ptr] * 7)
    return lib


def declare_refit(lib):
    """Declare csrc/refit.cu's entry points on a loaded library."""
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.rtk_refit_parents.restype = i32
    lib.rtk_refit_parents.argtypes = [ptr, ptr, i64, i64, ptr, ptr]
    lib.rtk_refit_leaves.restype = i32
    lib.rtk_refit_leaves.argtypes = [ptr, i64, ptr, i64, i32] + [ptr] * 11
    lib.rtk_refit_slots.restype = i32
    lib.rtk_refit_slots.argtypes = [ptr] + [i64] * 3 + [ptr] * 7
    lib.rtk_repack.restype = i32
    lib.rtk_repack.argtypes = ([ptr, ptr, i64, i32] + [ptr, ptr, i64] * 3
                               + [ptr] * 3 + [i64] + [ptr] * 4)
    return lib


def _build(flt: JitFilter | None):
    """Build and load one kernel library -> (ctypes library, compiler
    output, seconds)."""
    t0 = time.perf_counter()
    so, log = kernel_library(flt)
    return bind_library(so, flt is None), log, time.perf_counter() - t0


def load_kernel(filter_fn: JitFilter | None = None):
    """Build (at first use, keyed on the source hash and, for a filter
    build, the predicate's) and load the kernel library.  Raises if nvcc
    is missing or the build fails."""
    key = None if filter_fn is None else filter_fn.key
    if key not in _libs:
        _libs[key], BUILD_LOGS[key], BUILD_SECONDS[key] = _build(filter_fn)
    return _libs[key]


def check_tensor(a, what, dtype, shape, dev):
    """Raise ValueError unless `a` is on `dev` with `dtype` and `shape`
    (None: any size): the launch wrappers' check of their tensors."""
    if (a.device != dev or a.dtype != dtype or a.dim() != len(shape)
            or any(w is not None and g != w
                   for g, w in zip(a.shape, shape))):
        want = tuple("*" if w is None else w for w in shape)
        raise ValueError(f"{what} must be a {dtype} {want} tensor on {dev}, "
                         f"not {a.dtype} {tuple(a.shape)} on {a.device}")


def launch(device: torch.device, entry: str, call, *args) -> None:
    """call(*args, stream) on `device`'s current stream: the library's
    `entry` or a function that marshals its arguments, returning its CUDA
    error code; a code other than 0 raises RuntimeError."""
    with torch.cuda.device(device):
        err = call(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: CUDA error {err}")

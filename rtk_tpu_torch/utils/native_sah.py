"""ctypes binding for the native C++ binned-SAH builder / corrected-rtk
oracle (native/rtk_oracle.cpp, shared with rtk_tpu).

Compiled on demand with g++ into rtk_tpu_torch/build/ (utils/build.py),
never into native/build/, which rtk_tpu's own binding writes.  Two roles:
  * the host-side SAH topology source for builder/sah.py;
  * an independent implementation of the trace semantics for tests and
    record-parity checks.
"""
from __future__ import annotations

import ctypes

import numpy as np

from rtk_tpu_torch.utils.build import PKG_ROOT, build_shared

_SRC = PKG_ROOT.parent / "native" / "rtk_oracle.cpp"
_lib = None


def _load():
    global _lib
    if _lib is not None:
        return _lib
    so, _ = build_shared("rtk_oracle", [_SRC],
                         ["g++", "-O2", "-std=c++17", "-msse4.1", "-shared",
                          "-fPIC"])
    lib = ctypes.CDLL(str(so))
    fp = ctypes.POINTER(ctypes.c_float)
    ip = ctypes.POINTER(ctypes.c_int32)
    lib.rtko_build.restype = ctypes.c_void_p
    lib.rtko_build.argtypes = [fp, ctypes.c_int64]
    lib.rtko_build2.restype = ctypes.c_void_p
    lib.rtko_build2.argtypes = [fp, ctypes.c_int64, ctypes.c_int]
    lib.rtko_build3.restype = ctypes.c_void_p
    lib.rtko_build3.argtypes = [fp, ctypes.c_int64, ctypes.c_int,
                                ctypes.c_int]
    lib.rtko_trace.restype = None
    lib.rtko_trace.argtypes = [ctypes.c_void_p, fp, ctypes.c_int64,
                               ctypes.c_int, fp, fp, fp, ip]
    lib.rtko_free.restype = None
    lib.rtko_free.argtypes = [ctypes.c_void_p]
    lib.rtko_build4.restype = ctypes.c_void_p
    lib.rtko_build4.argtypes = [fp, ctypes.c_int64, ctypes.c_int]
    lib.rtko_trace4.restype = None
    lib.rtko_trace4.argtypes = lib.rtko_trace.argtypes
    lib.rtko_free4.restype = None
    lib.rtko_free4.argtypes = [ctypes.c_void_p]
    lib.rtko_node_count.restype = ctypes.c_int64
    lib.rtko_node_count.argtypes = [ctypes.c_void_p]
    lib.rtko_export.restype = None
    lib.rtko_export.argtypes = [ctypes.c_void_p, ip, ip, ip, ip, fp, fp,
                                ip, ip]
    _lib = lib
    return lib


def _ptr(a, kind):
    return a.ctypes.data_as(ctypes.POINTER(kind))


def _trace_rays(fn, handle, origin, direction, min_t, max_t, mode):
    """One rtko_trace / rtko_trace4 call -> (t, u, v, tri_index)."""
    n = len(origin)
    rays = np.empty((n, 8), np.float32)
    rays[:, 0:3] = origin
    rays[:, 3:6] = direction
    rays[:, 6] = min_t
    rays[:, 7] = max_t
    t, u, v = (np.empty(n, np.float32) for _ in range(3))
    idx = np.empty(n, np.int32)
    f = ctypes.c_float
    fn(handle, _ptr(rays, f), n, 0 if mode == "closest" else 1, _ptr(t, f),
       _ptr(u, f), _ptr(v, f), _ptr(idx, ctypes.c_int32))
    return t, u, v, idx


class NativeOracle:
    """Corrected-rtk CPU oracle: build once, trace ray batches."""

    def __init__(self, tri_pos: np.ndarray, leaf_max: int | None = None,
                 step_quant: bool = False):
        """step_quant: weight the SAH by leaf steps (ceil(count/leaf_max))
        instead of triangle count; topology only, hits are identical."""
        lib = _load()
        tris = np.ascontiguousarray(tri_pos, np.float32).reshape(-1, 9)
        self._n = tris.shape[0]
        fp = _ptr(tris, ctypes.c_float)
        if leaf_max is None:
            self._handle = lib.rtko_build(fp, self._n)
        elif step_quant:
            self._handle = lib.rtko_build3(fp, self._n, int(leaf_max),
                                           int(leaf_max))
        else:
            self._handle = lib.rtko_build2(fp, self._n, int(leaf_max))
        self._lib = lib

    def export_tree(self):
        """-> (left, right, first, count, box_lo, box_hi, order, root):
        the host-SAH binary topology, for pack_binary_tree."""
        nn = int(self._lib.rtko_node_count(self._handle))
        left, right, first, count = (np.empty(nn, np.int32)
                                     for _ in range(4))
        box_lo = np.empty((nn, 3), np.float32)
        box_hi = np.empty((nn, 3), np.float32)
        order = np.empty(self._n, np.int32)
        root = np.empty(1, np.int32)
        i, f = ctypes.c_int32, ctypes.c_float
        self._lib.rtko_export(
            self._handle, _ptr(left, i), _ptr(right, i), _ptr(first, i),
            _ptr(count, i), _ptr(box_lo, f), _ptr(box_hi, f),
            _ptr(order, i), _ptr(root, i))
        return left, right, first, count, box_lo, box_hi, order, int(root[0])

    def trace(self, origin, direction, min_t, max_t, mode="closest"):
        """-> (t, u, v, tri_index) numpy arrays; index -1 on miss."""
        return _trace_rays(self._lib.rtko_trace, self._handle, origin,
                           direction, min_t, max_t, mode)

    def __del__(self):
        lib = getattr(self, "_lib", None)
        if lib is not None:
            lib.rtko_free(self._handle)


class NativeOracleSSE:
    """Clean-room SSE BVH4 CPU tracer: the reference's own kernel is a
    4-wide SSE BVH4 (rtk.c:181-539), so this, not the scalar BVH2 oracle
    above, is the CPU baseline a ratio should be quoted against."""

    def __init__(self, tri_pos: np.ndarray, leaf_max: int = 4):
        lib = _load()
        tris = np.ascontiguousarray(tri_pos, np.float32).reshape(-1, 9)
        self._n = tris.shape[0]
        self._handle = lib.rtko_build4(_ptr(tris, ctypes.c_float), self._n,
                                       int(leaf_max))
        self._lib = lib

    def trace(self, origin, direction, min_t, max_t, mode="closest"):
        """-> (t, u, v, tri_index) numpy arrays; index -1 on miss."""
        return _trace_rays(self._lib.rtko_trace4, self._handle, origin,
                           direction, min_t, max_t, mode)

    def __del__(self):
        lib = getattr(self, "_lib", None)
        if lib is not None:
            lib.rtko_free4(self._handle)

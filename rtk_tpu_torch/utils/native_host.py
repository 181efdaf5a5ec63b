"""ctypes binding for the native host runtime (native/rtk_host.cpp, shared
with rtk_tpu).

Threaded C++ decode of raw mesh buffers (strided / u16 / u32 / f32 / f64)
into the canonical packed arrays the device build consumes: the native
analogue of the reference's host-side decode tasks (rtk.c:1028-1114).
Compiled on demand with g++ into rtk_tpu_torch/build/ (utils/build.py).
mesh.py asks available() first and decodes with NumPy where no C++
toolchain is present; both paths give the same bytes.
"""
from __future__ import annotations

import ctypes

import numpy as np

from rtk_tpu_torch.utils.build import PKG_ROOT, build_shared

_SRC = PKG_ROOT.parent / "native" / "rtk_host.cpp"
_lib = None
_lib_failed = False

_F32, _F64, _U16, _U32 = 0, 1, 2, 3


def _load():
    global _lib, _lib_failed
    if _lib is not None or _lib_failed:
        return _lib
    try:
        so, _ = build_shared("rtk_host", [_SRC],
                             ["g++", "-O2", "-std=c++17", "-shared", "-fPIC",
                              "-pthread"])
        lib = ctypes.CDLL(str(so))
    except (OSError, RuntimeError):  # no g++, a failed build, a bad library
        _lib_failed = True
        return None
    fp = ctypes.POINTER(ctypes.c_float)
    up = ctypes.POINTER(ctypes.c_uint32)
    lib.rtkh_decode_positions.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int, fp,
        ctypes.c_int]
    lib.rtkh_decode_indices.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int, up,
        ctypes.c_int]
    lib.rtkh_gather_soup.argtypes = [fp, up, ctypes.c_int64, fp,
                                     ctypes.c_int]
    lib.rtkh_hardware_threads.restype = ctypes.c_int
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


def _threads(lib, n_items) -> int:
    hw = lib.rtkh_hardware_threads()
    return max(1, min(hw, int(n_items) >> 16 or 1))


def _ptr(a, kind):
    return a.ctypes.data_as(ctypes.POINTER(kind))


def _decode(fn_name, buf, out, count, stride, kind, c_type):
    lib = _load()
    assert lib is not None
    buf = bytes(buf) if not isinstance(buf, bytes) else buf
    src = ctypes.cast(ctypes.c_char_p(buf), ctypes.c_void_p)  # no copy
    getattr(lib, fn_name)(src, count, stride, kind, _ptr(out, c_type),
                          _threads(lib, count))
    return out


def decode_positions(buf: bytes, count: int, stride: int,
                     dtype: str) -> np.ndarray:
    """(count, 3) f32 from a strided raw buffer; dtype 'f32' or 'f64'."""
    return _decode("rtkh_decode_positions", buf,
                   np.empty((count, 3), np.float32), count, stride,
                   _F64 if dtype == "f64" else _F32, ctypes.c_float)


def decode_indices(buf: bytes, count: int, stride: int,
                   dtype: str) -> np.ndarray:
    """(count,) u32 from a strided raw buffer; dtype 'u16' or 'u32'."""
    return _decode("rtkh_decode_indices", buf, np.empty((count,), np.uint32),
                   count, stride, _U16 if dtype == "u16" else _U32,
                   ctypes.c_uint32)


def gather_soup(positions: np.ndarray, indices: np.ndarray) -> np.ndarray:
    """(len(indices), 3) f32 = positions[indices] (threaded gather)."""
    lib = _load()
    assert lib is not None
    positions = np.ascontiguousarray(positions, np.float32)
    indices = np.ascontiguousarray(indices, np.uint32).reshape(-1)
    out = np.empty((indices.shape[0], 3), np.float32)
    lib.rtkh_gather_soup(_ptr(positions, ctypes.c_float),
                         _ptr(indices, ctypes.c_uint32), indices.shape[0],
                         _ptr(out, ctypes.c_float),
                         _threads(lib, indices.shape[0]))
    return out

"""Mesh ingestion: flexible triangle-mesh descriptions -> canonical soup.

Parity with the reference mesh input layer (rtk.h:54-76, rtk.c:1028-1114):
  * positions: f32 or f64, arbitrary byte stride, or a user callback;
  * indices: u16 or u32, arbitrary byte stride, an implicit triangle list
    (index buffer absent -> triangle i uses vertices 3i, 3i+1, 3i+2), or a
    user callback;
  * multiple meshes per scene, each triangle remembering its mesh index,
    its triangle index within the mesh, and the three *original* vertex
    indices (rtk_vertex.index, rtk.h:24-27).

Host-side NumPy code that runs once per scene upload, before the device
build.  Raw buffers of at least NATIVE_DECODE_MIN elements decode through
the threaded C++ host runtime (utils/native_host.py) where a C++
toolchain is present, and through NumPy otherwise; both give the same
bytes.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Union

import numpy as np

# rtk_type equivalents (rtk.h:45-52). "default" resolves to f32 for
# positions and u32 for indices (rtk.h:68-69).
_POS_DTYPES = {"default": np.float32, "f32": np.float32, "f64": np.float64}
_IDX_DTYPES = {"default": np.uint32, "u16": np.uint16, "u32": np.uint32}

PositionCallback = Callable[[object, np.ndarray], np.ndarray]
IndexCallback = Callable[[object, int, int], np.ndarray]


@dataclasses.dataclass
class MeshDesc:
    """Description of one triangle mesh (parity: rtk_mesh, rtk.h:64-76).

    Exactly one of (positions, position_cb) must be given; indices may be an
    array, a raw byte buffer, a callback, or None for an implicit triangle
    list.
    """

    num_triangles: int
    positions: Optional[Union[np.ndarray, bytes, bytearray, memoryview]] = None
    position_stride: Optional[int] = None  # bytes between vertices (raw input)
    position_type: str = "default"  # "f32" | "f64"
    indices: Optional[Union[np.ndarray, bytes, bytearray, memoryview]] = None
    index_stride: Optional[int] = None  # bytes between consecutive indices
    index_type: str = "default"  # "u16" | "u32"
    # position_cb(user, indices)->(len(indices),3) positions;
    # index_cb(user, offset, count)->(count*3,) u32 indices (rtk.h:61-62).
    position_cb: Optional[PositionCallback] = None
    index_cb: Optional[IndexCallback] = None
    user: object = None


def _decode_strided(buf, count, n_comp, dtype, stride) -> np.ndarray:
    """Decode `count` records of n_comp dtype-typed components from raw bytes
    placed `stride` bytes apart (rtk's strided decode, rtk.c:1028-1114)."""
    itemsize = np.dtype(dtype).itemsize
    natural = itemsize * n_comp
    if stride is None or stride == natural:
        arr = np.frombuffer(buf, dtype=dtype, count=count * n_comp)
        return arr.reshape(count, n_comp)
    raw = np.frombuffer(buf, dtype=np.uint8)
    out = np.empty((count, n_comp), dtype=dtype)
    for c in range(n_comp):
        start = c * itemsize
        view = np.lib.stride_tricks.as_strided(
            raw[start:], shape=(count, itemsize), strides=(stride, 1))
        out[:, c] = view.copy().view(dtype)[:, 0]
    return out


# Raw-buffer decodes from this element count on route through the threaded
# C++ host runtime (native/rtk_host.cpp) when the toolchain is available.
NATIVE_DECODE_MIN = 1 << 18


def _native():
    from rtk_tpu_torch.utils import native_host

    return native_host if native_host.available() else None


def decode_indices(mesh: MeshDesc) -> np.ndarray:
    """-> (T, 3) u32 original vertex indices."""
    t = mesh.num_triangles
    if mesh.index_cb is not None:
        idx = np.asarray(mesh.index_cb(mesh.user, 0, t), dtype=np.uint32)
        return idx.reshape(t, 3)
    if mesh.indices is None:
        # Implicit triangle list (rtk.c:1060-1067).
        return np.arange(t * 3, dtype=np.uint32).reshape(t, 3)
    if isinstance(mesh.indices, np.ndarray):
        idx = mesh.indices
        if idx.ndim == 1:
            idx = idx.reshape(-1, 3)
        return idx[:t].astype(np.uint32)
    # Raw buffer: stride applies between consecutive *indices* (rtk_buffer
    # semantics, rtk.h:54-58).
    dtype = _IDX_DTYPES[mesh.index_type]
    nh = _native() if t * 3 >= NATIVE_DECODE_MIN else None
    if nh is not None:
        stride = mesh.index_stride or np.dtype(dtype).itemsize
        kind = "u16" if dtype == np.uint16 else "u32"
        return nh.decode_indices(bytes(mesh.indices), t * 3, stride,
                                 kind).reshape(t, 3)
    idx = _decode_strided(mesh.indices, t * 3, 1, dtype, mesh.index_stride)
    return idx.reshape(t, 3).astype(np.uint32)


def decode_positions(mesh: MeshDesc, indices: np.ndarray) -> np.ndarray:
    """-> (T, 3, 3) f32 triangle corner positions for the given index triples."""
    if mesh.position_cb is not None:
        flat = indices.reshape(-1)
        pos = np.asarray(mesh.position_cb(mesh.user, flat), dtype=np.float32)
        return pos.reshape(indices.shape[0], 3, 3)
    if isinstance(mesh.positions, np.ndarray):
        verts = mesh.positions.reshape(-1, 3).astype(np.float32)
    else:
        dtype = _POS_DTYPES[mesh.position_type]
        nbytes = len(mesh.positions)
        natural = np.dtype(dtype).itemsize * 3
        stride = mesh.position_stride or natural
        # The final record only needs its 3 components present, not a full
        # stride of padding after it (rtk_buffer semantics, rtk.h:54-58).
        count = (nbytes - natural) // stride + 1 if nbytes >= natural else 0
        nh = _native() if count >= NATIVE_DECODE_MIN else None
        if nh is not None:
            kind = "f64" if dtype == np.float64 else "f32"
            verts = nh.decode_positions(bytes(mesh.positions), count,
                                        stride, kind)
        else:
            verts = _decode_strided(mesh.positions, count, 3, dtype, stride)
            verts = verts.astype(np.float32)
    flat = indices.reshape(-1)
    if flat.size and int(flat.max()) >= verts.shape[0]:
        raise ValueError(
            f"mesh index {int(flat.max())} out of range for "
            f"{verts.shape[0]} decoded vertices (check index_stride / "
            "index_type / position_stride against rtk_buffer semantics: "
            "stride is between consecutive elements, rtk.h:54-58)")
    nh = _native() if flat.shape[0] >= NATIVE_DECODE_MIN else None
    if nh is not None:
        return nh.gather_soup(verts, flat).reshape(indices.shape[0], 3, 3)
    return verts[flat].reshape(indices.shape[0], 3, 3)


@dataclasses.dataclass
class TriangleSoup:
    """Canonical host-side scene geometry (all meshes concatenated)."""

    tri_pos: np.ndarray  # (T, 3, 3) f32
    tri_vidx: np.ndarray  # (T, 3) i32 original vertex indices
    tri_mesh: np.ndarray  # (T,) i32 mesh index
    tri_prim: np.ndarray  # (T,) i32 triangle index within its mesh

    @property
    def num_triangles(self) -> int:
        return self.tri_pos.shape[0]


def as_mesh_desc(m) -> MeshDesc:
    if isinstance(m, MeshDesc):
        return m
    if isinstance(m, tuple) and len(m) == 2:
        positions, indices = m
        indices = np.asarray(indices).reshape(-1, 3)
        return MeshDesc(num_triangles=indices.shape[0],
                        positions=np.asarray(positions), indices=indices)
    raise TypeError(f"cannot interpret {type(m)} as a mesh")


def build_soup(meshes: Union[MeshDesc, tuple, Sequence]) -> TriangleSoup:
    """Decode and concatenate meshes into a canonical triangle soup."""
    if isinstance(meshes, (MeshDesc, tuple)):
        meshes = [meshes]
    pos, vidx, mids, prims = [], [], [], []
    for mi, m in enumerate(meshes):
        m = as_mesh_desc(m)
        idx = decode_indices(m)
        t = m.num_triangles
        pos.append(decode_positions(m, idx))
        vidx.append(idx.astype(np.int32))
        mids.append(np.full((t,), mi, np.int32))
        prims.append(np.arange(t, dtype=np.int32))
    return TriangleSoup(
        tri_pos=np.concatenate(pos, axis=0),
        tri_vidx=np.concatenate(vidx, axis=0),
        tri_mesh=np.concatenate(mids, axis=0),
        tri_prim=np.concatenate(prims, axis=0),
    )

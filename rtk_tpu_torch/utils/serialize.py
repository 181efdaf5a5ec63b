"""Scene serialization: the versioned, relocatable container of
rtk_tpu.utils.serialize, byte for byte.

The reference's scene *is* its file format: a relocatable blob with a
magic/endian/version/sizeof_real header and a byte-offset section table
(rtk.h:78-89, rtk.c:1732-1774).  The layout, shared with rtk_tpu so that
a blob saved by either package loads in the other:

  header:  magic "\\0RTK8TPU" (8 bytes), endian mark 0xAABB (u16),
           sizeof_real (u8), kind (u8), version (u32),
           total size (u64), section count (u32),
           static-metadata block (u32 count + i64 x count).
  section: name (24 bytes), dtype code (u8), ndim (u8), pad (u16),
           shape (u32 x 4), byte offset (u64, 128-aligned), byte size
           (u64).

Three container kinds: 0 Scene, 1 PackedScene (meta slot 3 holds the node
table's branching), 2 InstancedScene (the merged Scene's sections under
"m.").  Arrays are little-endian and contiguous.  Loading checks magic,
endianness, sizeof_real and version, and puts the arrays on `device`.
"""
from __future__ import annotations

import io
import os
import struct as pystruct
from typing import BinaryIO, Union

import numpy as np
import torch

from rtk_tpu_torch.instancing import InstancedScene
from rtk_tpu_torch.scene import Scene
from rtk_tpu_torch.trace.packed import PackedScene, tree_depth
from rtk_tpu_torch.trace.stack import wide_depth

MAGIC = b"\x00RTK8TPU"
ENDIAN_MARK = 0xAABB
VERSION = 2
ALIGN = 128

KIND_SCENE = 0
KIND_PACKED = 1
KIND_INSTANCED = 2

_DTYPES = {0: np.float32, 1: np.int32, 2: np.uint32, 3: np.float64,
           4: np.int64, 5: np.uint8}
_DTYPE_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}

# Scene array fields in serialization order.
_FIELDS = [
    "node_child", "node_min", "node_max", "bin_left", "bin_right",
    "bin_lo", "bin_hi",
    "bin_min", "bin_max", "leaf_min", "leaf_max",
    "tri_v", "tri_vidx", "tri_mesh", "tri_prim", "perm",
    "bounds_min", "bounds_max",
]

_PACKED_FIELDS = [
    "nodes", "meta", "tris", "tri_v", "tri_vidx", "tri_mesh", "tri_prim",
    "slot_src", "tri_perm",
]

_INSTANCED_FIELDS = [
    "roots", "instance_blas", "world_from_object", "object_from_world",
    "inst_lo", "inst_hi",
]

Source = Union[str, os.PathLike, bytes, bytearray, memoryview, BinaryIO]


def _align(n: int) -> int:
    return (n + ALIGN - 1) // ALIGN * ALIGN


def _host(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _save_container(kind: int, arrays: dict, meta_ints, f: BinaryIO) -> int:
    meta = pystruct.pack("<I", len(meta_ints))
    meta += pystruct.pack(f"<{len(meta_ints)}q", *meta_ints)

    header_size = 8 + 2 + 1 + 1 + 4 + 8 + 4 + len(meta)
    sec_entry = 24 + 1 + 1 + 2 + 4 * 4 + 8 + 8
    offset = _align(header_size + sec_entry * len(arrays))

    entries = []
    for name, a in arrays.items():
        a = np.ascontiguousarray(_host(a))
        if a.ndim > 4:
            raise ValueError(f"{name}: ndim > 4")
        if len(name.encode()) > 24:
            raise ValueError(f"section name too long: {name}")
        entries.append((name, a, offset))
        offset = _align(offset + a.nbytes)
    total = offset

    blob = bytearray(total)
    head = io.BytesIO()
    head.write(MAGIC)
    head.write(pystruct.pack("<HBB", ENDIAN_MARK, 4, kind))  # sizeof_real
    head.write(pystruct.pack("<I", VERSION))
    head.write(pystruct.pack("<Q", total))
    head.write(pystruct.pack("<I", len(arrays)))
    head.write(meta)
    for name, a, off in entries:
        shape = list(a.shape) + [0] * (4 - a.ndim)
        head.write(name.encode().ljust(24, b"\x00"))
        head.write(pystruct.pack("<BBH", _DTYPE_CODES[a.dtype], a.ndim, 0))
        head.write(pystruct.pack("<4I", *shape))
        head.write(pystruct.pack("<QQ", off, a.nbytes))
        blob[off:off + a.nbytes] = a.astype(a.dtype.newbyteorder("<"),
                                             copy=False).tobytes()
    head = head.getvalue()
    blob[:len(head)] = head
    f.write(bytes(blob))
    return total


def _load_container(data: bytes):
    """-> (kind, {name: host array}, meta ints), validating the header."""
    if data[:8] != MAGIC:
        raise ValueError("not an rtk_tpu scene (bad magic)")
    endian, sizeof_real, kind = pystruct.unpack_from("<HBB", data, 8)
    if endian != ENDIAN_MARK:
        raise ValueError("endianness mismatch")
    if sizeof_real != 4:
        raise ValueError(f"unsupported sizeof_real {sizeof_real}")
    (version,) = pystruct.unpack_from("<I", data, 12)
    if version != VERSION:
        raise ValueError(f"unsupported version {version}")
    (total,) = pystruct.unpack_from("<Q", data, 16)
    if total > len(data):
        raise ValueError("truncated scene blob")
    (n_sec,) = pystruct.unpack_from("<I", data, 24)
    (n_meta,) = pystruct.unpack_from("<I", data, 28)
    meta_ints = pystruct.unpack_from(f"<{n_meta}q", data, 32)

    pos = 32 + 8 * n_meta
    arrays = {}
    for _ in range(n_sec):
        name = data[pos:pos + 24].rstrip(b"\x00").decode()
        dtype_code, ndim, _ = pystruct.unpack_from("<BBH", data, pos + 24)
        shape = pystruct.unpack_from("<4I", data, pos + 28)[:ndim]
        off, size = pystruct.unpack_from("<QQ", data, pos + 44)
        dt = np.dtype(_DTYPES[dtype_code]).newbyteorder("<")
        arr = np.frombuffer(data, dtype=dt, count=size // dt.itemsize,
                            offset=off).reshape(shape)
        arrays[name] = arr.astype(dt.newbyteorder("="))
        pos += 60
    return kind, arrays, meta_ints


def _load(data: bytes, want: int, what: str, device):
    """Container of kind `want` -> ({name: tensor on device}, meta)."""
    kind, arrays, meta_ints = _load_container(data)
    if kind != want:
        raise ValueError(f"blob holds kind {kind}, not {what} (use "
                         "load_any)")
    return {k: torch.as_tensor(a, device=device)
            for k, a in arrays.items()}, meta_ints


def _read(f: Source) -> bytes:
    if isinstance(f, (str, os.PathLike)):
        with open(f, "rb") as fh:
            return fh.read()
    if isinstance(f, (bytes, bytearray, memoryview)):
        return bytes(f)
    return f.read()


def _write(f, save):
    if isinstance(f, (str, os.PathLike)):
        with open(f, "wb") as fh:
            return save(fh)
    return save(f)


def save_scene(scene, f) -> int:
    """Serialize a base Scene; returns total bytes written."""
    arrays = {name: getattr(scene, name) for name in _FIELDS}
    meta = (scene.num_tris, scene.leaf_size, scene.branching,
            scene.num_leaves, int(scene.has_wide))
    return _write(f, lambda fh: _save_container(KIND_SCENE, arrays, meta,
                                                fh))


def _scene_from(arrays, meta_ints, prefix=""):
    missing = [n for n in _FIELDS if prefix + n not in arrays]
    if missing:
        raise ValueError(f"scene blob missing sections: {missing}")
    num_tris, leaf_size, branching, num_leaves = meta_ints[:4]
    # 5th int: wide-array presence; older blobs lack it (always wide).
    has_wide = bool(meta_ints[4]) if len(meta_ints) > 4 else True
    return Scene(num_tris=int(num_tris), leaf_size=int(leaf_size),
                 branching=int(branching), num_leaves=int(num_leaves),
                 has_wide=has_wide,
                 **{n: arrays[prefix + n] for n in _FIELDS})


def load_scene(f: Source, device="cuda"):
    """Deserialize a Scene onto `device`, validating magic, endianness
    and version."""
    arrays, meta_ints = _load(_read(f), KIND_SCENE, "a base Scene", device)
    return _scene_from(arrays, meta_ints)


def save_packed_scene(packed, f) -> int:
    """Serialize a PackedScene (the kernel tables): load and trace with no
    repack, like rtk's blob (rtk.c:1732-1774)."""
    arrays = {name: getattr(packed, name) for name in _PACKED_FIELDS}
    # Slot 2 was the reference's pruned kz_tables flag, always 0; slot 3
    # the node table's wide arity.
    meta = (packed.num_tris, packed.leaf_size, 0, packed.branching)
    return _write(f, lambda fh: _save_container(KIND_PACKED, arrays, meta,
                                                fh))


def load_packed_scene(f: Source, device="cuda"):
    """Deserialize a PackedScene onto `device`.  Its traversal depth is
    read back from the meta table (the deepest tree over every root)."""
    arrays, meta_ints = _load(_read(f), KIND_PACKED, "a PackedScene",
                              device)
    num_tris, leaf_size = meta_ints[:2]
    if len(meta_ints) > 2 and meta_ints[2]:
        raise ValueError("blob was saved with kz_tables=True, which is "
                         "no longer supported; re-pack the scene")
    branching = int(meta_ints[3]) if len(meta_ints) > 3 else 8
    if branching not in (8, 16):
        raise ValueError(f"blob holds {branching}-wide packed tables; "
                         "the kernel reads 8- or 16-wide tables")
    return PackedScene(
        num_tris=int(num_tris), leaf_size=int(leaf_size),
        branching=branching,
        depth=tree_depth(arrays["meta"].cpu().numpy(), w=branching),
        **{n: arrays[n] for n in _PACKED_FIELDS})


def save_instanced_scene(iscene, f) -> int:
    """Serialize an InstancedScene (merged BLAS forest + instance table);
    the merged Scene's sections are prefixed "m."."""
    arrays = {"m." + n: getattr(iscene.merged, n) for n in _FIELDS}
    for n in _INSTANCED_FIELDS:
        arrays[n] = getattr(iscene, n)
    m = iscene.merged
    meta = (m.num_tris, m.leaf_size, m.branching, m.num_leaves,
            *iscene.blas_tris)
    return _write(f, lambda fh: _save_container(KIND_INSTANCED, arrays,
                                                meta, fh))


def load_instanced_scene(f: Source, device="cuda"):
    """Deserialize an InstancedScene onto `device`.  The per-BLAS padded
    row counts and the stack bound are derived again, as build_instanced
    derives them."""
    arrays, meta_ints = _load(_read(f), KIND_INSTANCED,
                              "an InstancedScene", device)
    merged = _scene_from(arrays, meta_ints[:4], prefix="m.")
    blas_tris = tuple(int(x) for x in meta_ints[4:])
    k = merged.leaf_size
    roots = arrays["roots"]
    return InstancedScene(
        merged=merged, blas_tris=blas_tris,
        blas_slots=tuple(max(1, -(-t // k)) * k for t in blas_tris),
        max_stack=wide_depth(merged, roots.cpu().numpy())
        * (merged.branching - 1),
        **{n: arrays[n] for n in _INSTANCED_FIELDS})


def load_any(f: Source, device="cuda"):
    """Load whichever container kind the blob holds."""
    data = _read(f)
    kind, _, _ = _load_container(data)
    loaders = {KIND_SCENE: load_scene, KIND_PACKED: load_packed_scene,
               KIND_INSTANCED: load_instanced_scene}
    if kind not in loaders:
        raise ValueError(f"unknown container kind {kind}")
    return loaders[kind](data, device=device)

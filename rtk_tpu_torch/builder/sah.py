"""SAH build option: host-native binned-SAH topology, device-packed.

The default builder is the on-device LBVH (scene.py).  For static scenes
traced many times, a higher-quality tree pays for itself: this builds the
binary topology with the native C++ binned-SAH builder (rtk's build
strategy, rtk.c:867-1019) and feeds it through the same greedy wide
collapse as the LBVH path, so the kernel sees the identical table format.
"""
from __future__ import annotations

import numpy as np

from rtk_tpu_torch.config import BuildConfig
from rtk_tpu_torch.mesh import TriangleSoup, build_soup
from rtk_tpu_torch.trace.packed import pack_binary_tree
from rtk_tpu_torch.utils.native_sah import NativeOracle


def build_sah_packed(meshes, config: BuildConfig = BuildConfig(),
                     tri_mask=None, step_quant: bool = False,
                     refittable: bool = False, device="cuda"):
    """Build a PackedScene with host-native binned-SAH topology on `device`.

    Accepts the same mesh inputs as build_scene (MeshDesc, (positions,
    indices), TriangleSoup, or a sequence).  Returns the kernel tables
    directly (no intermediate Scene).

    step_quant: weight the SAH by leaf steps (ceil(count/leaf_size)), the
    unit the kernel tests leaves in; topology only.

    refittable=True returns (packed, BinaryRefitAux) instead: the binned
    SAH partitions triangles in place, so the tree refits on the device
    with the LBVH's range queries (refit_packed_binary,
    trace_packets_refit[_frames]), and a deforming scene keeps the SAH
    topology for as long as the deformation leaves the tree good.
    """
    soup = meshes if isinstance(meshes, TriangleSoup) else build_soup(meshes)
    tri_pos = np.asarray(soup.tri_pos, np.float32)
    orc = NativeOracle(tri_pos.reshape(-1, 9), leaf_max=config.leaf_size,
                       step_quant=step_quant)
    return pack_binary_tree(
        tri_pos, *orc.export_tree(), leaf_size=config.leaf_size,
        tri_vidx=soup.tri_vidx, tri_mesh=soup.tri_mesh,
        tri_prim=soup.tri_prim, tri_mask=tri_mask,
        return_refit_aux=refittable, device=device)


def build_sah_forest(blas_tri_pos, config: BuildConfig = BuildConfig(),
                     step_quant: bool = True, device="cuda"):
    """Host-SAH trees for a BLAS forest, packed as ONE multi-root table.

    blas_tri_pos: sequence of (T_b, 3, 3) soups, one per unique BLAS.
    Returns (PackedScene, packed_roots): packed_roots[b] is the packed
    entry row of BLAS b, the drop-in for pack_forest's output
    (pack_instanced(iscene, packed=..., packed_roots=...)).  tri_prim holds
    per-BLAS soup triangle ids and tri_perm ids into the concatenated
    soups, the record contract of the merged-LBVH path.
    """
    k = config.leaf_size
    parts = []
    for tp in blas_tri_pos:
        tp = np.asarray(tp, np.float32).reshape(-1, 3, 3)
        orc = NativeOracle(tp.reshape(-1, 9), leaf_max=k,
                           step_quant=step_quant)
        parts.append((tp, orc.export_tree()))
        del orc
    cols = [[] for _ in range(8)]  # left right first count lo hi order root
    prims = []
    node_off = tri_off = 0
    for tp, (left, right, first, count, lo, hi, order, root) in parts:
        for col, a in zip(cols, (
                np.where(left >= 0, left + node_off, -1),
                np.where(right >= 0, right + node_off, -1),
                first + tri_off, count, lo, hi,
                order.astype(np.int64) + tri_off, root + node_off)):
            col.append(a)
        # Records carry the triangle's index in its own BLAS soup, mesh 0.
        prims.append(np.arange(tp.shape[0], dtype=np.int64))
        node_off += left.shape[0]
        tri_off += tp.shape[0]
    tri_v = np.concatenate([tp for tp, _ in parts])
    packed = pack_binary_tree(
        tri_v, *(np.concatenate(c) for c in cols[:7]),
        np.asarray(cols[7], np.int64), leaf_size=k,
        tri_mesh=np.zeros(tri_v.shape[0], np.int64),
        tri_prim=np.concatenate(prims), device=device)
    return packed, np.arange(len(parts), dtype=np.int64)

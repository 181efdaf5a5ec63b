"""PackedScene: the kernel's scene tables (rtk_tpu.trace.packed, in torch).

The packed wide tree is built from the *binary* topology with a greedy
collapse: starting from a node's two children, repeatedly expand the
internal slot with the largest surface area until all 8 slots are used.
Nodes are numbered in BFS order with each node's internal children (and
leaf children) contiguous, so the kernel derives every child pointer from
(first_child, first_leaf, slot masks).  The host part (_greedy_slots,
_pack_meta) is the same NumPy code as rtk_tpu's; the tables are gathered
with torch on the scene's device and are bit-equal to rtk_tpu's.

Packing runs once per topology, on the host.  A refit regathers bounds
and vertices through the saved mappings on the device: repack_bounds for
a table packed from a Scene (on the card one launch, `repack_kernel`,
csrc/refit.cu; elsewhere its plain version, `repack_reference`, picked
by ops/packet_trace.py's `front_steps`), refit_packed_binary (with a
BinaryRefitAux) for one packed from a host-built binary tree.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

import rtk_tpu_torch.scene as scene_module
from rtk_tpu_torch.builder.lbvh import refit_ranges_flat
from rtk_tpu_torch.ops import library
from rtk_tpu_torch.scene import soup_tensor
from rtk_tpu_torch.utils.stats import span

W = 8
NODE_ROW_I32 = 8  # per child: [minx miny minz maxx maxy maxz meta0 meta1]
TRI_ROW_F32 = 16  # [v0(3) v1(3) v2(3) | mask mesh prim | 4 pad]

MASK_COL = 9  # filter-mask bits as an exact float value (<= 2^24)
MASK_ALL = float(0xFFFFFF)  # 24-bit all-pass mask
MESH_COL = 10  # mesh index as an exact float value
PRIM_COL = 11  # triangle index as an exact float value
# Calls of repack_bounds in this process, read back as scene.py's REFITS;
# REPACK_LAUNCHES counts the card repack's launches (repack_kernel, one a
# repack).
REPACKS = 0
REPACK_LAUNCHES = 0


@dataclasses.dataclass
class PackedScene:
    """Dense scene tables + mappings; product of pack_scene(scene).

    nodes holds W = branching rows per packed node (one per child slot, 8
    or 16): columns 0-5 are the child AABB (f32 bit patterns in an int32
    table), and the first two rows carry node metadata in columns 6-7:
    row0 = (first_child, first_leaf), row1 = (int_mask | leaf_mask << W,
    unused).  One node is W*32 contiguous bytes.
    """

    nodes: torch.Tensor  # (Nd*W, 8) i32 child rows with embedded meta
    meta: torch.Tensor  # (Nd, 4) i32: first_child, first_leaf, masks, pad
    tris: torch.Tensor  # (Tp, 16) f32 vertex rows in packed-leaf order
    # Hit-assembly arrays in packed order (indexed by the kernel's slot).
    tri_v: torch.Tensor  # (Tp, 3, 3) f32
    tri_vidx: torch.Tensor  # (Tp, 3) i32
    tri_mesh: torch.Tensor  # (Tp,) i32
    tri_prim: torch.Tensor  # (Tp,) i32
    slot_src: torch.Tensor  # (Nd, W) i32: binary node id / leaf code / -1
    tri_perm: torch.Tensor  # (Tp,) i32 source triangle per packed slot
    num_tris: int
    leaf_size: int
    # BFS levels of the deepest tree in the table (the maximum over its
    # roots); bounds the traversal stack at 1 + depth * (W - 1) entries.
    depth: int
    branching: int = W

    @property
    def num_nodes(self) -> int:
        return self.meta.shape[0]

    @property
    def num_padded_tris(self) -> int:
        return self.tri_v.shape[0]

    @property
    def device(self) -> torch.device:
        return self.nodes.device

    @property
    def stack_size(self) -> int:
        """Entries a depth-first traversal of this tree can hold at once:
        each level pops one entry and pushes at most W."""
        return 1 + self.depth * (self.branching - 1)


def _area(lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    d = np.maximum(hi - lo, 0.0)
    return d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2] + d[:, 2] * d[:, 0]


def _greedy_slots(left, right, area, root=0, w=W):
    """Greedy wide collapse, level by level (vectorised host NumPy).

    Returns slot_src (Nd, w) int64 (binary id >= 0, leaf code <= -2,
    -1 empty) in BFS order from `root`; internal children appear in
    row-major slot order, which is exactly the contiguous-child numbering.
    A leaf-code root becomes a single-leaf row.
    """
    levels = []
    frontier = np.atleast_1d(np.asarray(root, np.int64))
    first = True
    while frontier.size:
        f = frontier.shape[0]
        slots = np.full((f, w), -1, np.int64)
        if first:
            isleaf = frontier <= -2
            isempty = frontier == -1
            fc = np.clip(frontier, 0, None)
            slots[:, 0] = np.where(isempty, -1,
                                   np.where(isleaf, frontier, left[fc]))
            slots[:, 1] = np.where(isleaf | isempty, -1, right[fc])
            first = False
        else:
            slots[:, 0] = left[frontier]
            slots[:, 1] = right[frontier]
        nslots = np.full(f, 2, np.int64)
        rows = np.arange(f)
        for _ in range(w - 2):
            internal = slots >= 0
            a = np.where(internal, area[np.clip(slots, 0, None)], -np.inf)
            a[nslots >= w] = -np.inf  # no free slot left
            pick = a.argmax(1)
            ok = a[rows, pick] > -np.inf
            b = slots[rows, pick]
            bc = np.clip(b, 0, None)
            r = rows[ok]
            slots[r, pick[ok]] = left[bc][ok]
            slots[r, nslots[ok]] = right[bc][ok]
            nslots[ok] += 1
        levels.append(slots)
        frontier = slots[slots >= 0]
    return np.concatenate(levels, axis=0)


def _pack_meta(slot_src: np.ndarray, node_base: int = 0,
               leaf_base: int = 0, root_rows: int = 1):
    """(first_child, first_leaf, masks) per node + leaf visit order.

    node_base/leaf_base offset the contiguous numbering of one block of a
    multi-block forest (pack_forest).  root_rows: the number of level-0
    rows (a multi-root BFS from _greedy_slots(root=array) puts all R roots
    first, so the first child row is R, not 1)."""
    int_m = slot_src >= 0
    leaf_m = slot_src <= -2
    n_int = int_m.sum(1)
    n_leaf = leaf_m.sum(1)
    fc = node_base + root_rows + np.concatenate([[0], np.cumsum(n_int)[:-1]])
    fl = leaf_base + np.concatenate([[0], np.cumsum(n_leaf)[:-1]])
    w = slot_src.shape[1]
    bits = 1 << np.arange(w, dtype=np.int64)[None, :]
    masks = (int_m * bits).sum(1) | ((leaf_m * bits).sum(1) << w)
    leaf_order = -slot_src[leaf_m] - 2  # row-major == fl ranks
    meta = np.stack(
        [fc, fl, masks, np.zeros_like(fc)], axis=1).astype(np.int32)
    return meta, leaf_order.astype(np.int64)


def _popcount(v: np.ndarray) -> np.ndarray:
    """Set bits of each value in [0, 2^32) (SWAR, int64 arrays)."""
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return (v * 0x01010101 & 0xFFFFFFFF) >> 24


def _internal_counts(meta: np.ndarray, w: int) -> np.ndarray:
    """Internal children per row: the low w bits of the masks word (the
    leaf mask rides above them, and at w=16 it reaches the sign bit)."""
    return _popcount(np.asarray(meta, np.int64)[:, 2] & ((1 << w) - 1))


def _ranks(counts: np.ndarray) -> np.ndarray:
    """0..c-1 for each entry c of counts, concatenated."""
    starts = np.cumsum(counts) - counts
    return np.arange(int(counts.sum())) - np.repeat(starts, counts)


def table_roots(meta: np.ndarray, w: int = W) -> np.ndarray:
    """Rows no other row names as an internal child: the entry rows of
    every tree in a w-wide table, whatever its layout."""
    meta = np.asarray(meta, np.int64)
    cnt = _internal_counts(meta, w)
    child = np.repeat(meta[:, 0], cnt) + _ranks(cnt)
    named = np.zeros(meta.shape[0], bool)
    named[child] = True
    return np.flatnonzero(~named)


def tree_depth(meta: np.ndarray, roots=None, w: int = W) -> int:
    """Number of BFS levels of the deepest tree of a w-wide packed table,
    read from its metadata: the maximum over `roots` (default:
    table_roots).

    Children are followed through (first_child, internal mask), so the
    walk is right for every layout: one tree, per-root blocks one after
    another (pack_forest), or R root rows first (pack_multiroot and the
    forest form of pack_binary_tree)."""
    meta = np.asarray(meta, np.int64)
    if roots is None:
        roots = table_roots(meta, w)
    rows = np.asarray(roots, np.int64).reshape(-1)
    if rows.size and (rows.min() < 0 or rows.max() >= meta.shape[0]):
        raise ValueError("tree root outside the node table")
    n_int = _internal_counts(meta, w)
    depth = 0
    while rows.size:
        if depth > meta.shape[0]:
            raise ValueError("node table has a cycle")
        depth += 1
        cnt = n_int[rows]
        rows = np.repeat(meta[rows, 0], cnt) + _ranks(cnt)
    return depth


def _gather_rows(bin_min, bin_max, leaf_min, leaf_max, slot_src, meta):
    """Build the (Nd*W, 8) i32 child rows with embedded metadata (W: the
    width of slot_src)."""
    slot_src = slot_src.to(torch.int64)
    internal = (slot_src >= 0)[..., None]
    leaf = (slot_src <= -2)[..., None]
    si = slot_src.clamp(0, bin_min.shape[0] - 1)
    li = (-slot_src - 2).clamp(0, leaf_min.shape[0] - 1)
    lo = torch.where(internal, bin_min[si],
                     torch.where(leaf, leaf_min[li], 1.0))
    hi = torch.where(internal, bin_max[si],
                     torch.where(leaf, leaf_max[li], -1.0))
    bounds = torch.cat([lo, hi], dim=-1).contiguous().view(torch.int32)
    nd, w = slot_src.shape
    rows = torch.zeros((nd, w, NODE_ROW_I32), dtype=torch.int32,
                       device=bounds.device)
    rows[..., :6] = bounds
    rows[:, 0, 6] = meta[:, 0]
    rows[:, 0, 7] = meta[:, 1]
    rows[:, 1, 6] = meta[:, 2]
    return rows.reshape(nd * w, NODE_ROW_I32)


def _tri_rows(tri_v, valid, mask=None, mesh=None, prim=None):
    """Kernel triangle table rows.  Padding slots (valid=False) become NaN
    vertices: the intersector rejects them through the t-window without
    ever taking the exact-sign path (NaN == 0 is false).

    Column MASK_COL carries the per-triangle filter bits as an exact float
    value (all-pass when no mask is given); MESH_COL and PRIM_COL carry the
    triangle's identity as exact float values."""
    tp = tri_v.shape[0]
    dev = tri_v.device
    f32 = dict(dtype=torch.float32, device=dev)
    flat = torch.where(valid[:, None], tri_v.reshape(tp, 9), float("nan"))

    def col(a, fill):
        if a is None:
            return torch.full((tp, 1), fill, **f32)
        return torch.as_tensor(a).to(**f32).reshape(tp, 1)

    return torch.cat([flat, col(mask, MASK_ALL), col(mesh, 0.0),
                      col(prim, -1.0), torch.zeros((tp, 4), **f32)], dim=1)


def _check_mask(tri_mask) -> np.ndarray:
    tri_mask = np.asarray(tri_mask, np.int64)
    if (tri_mask >> 24).any():
        raise ValueError("tri_mask uses more than 24 bits")
    return tri_mask


def _scene_binary(scene):
    """(left, right, area) of a Scene's binary topology on the host."""
    return (scene.bin_left.cpu().numpy().astype(np.int64),
            scene.bin_right.cpu().numpy().astype(np.int64),
            _area(scene.bin_min.cpu().numpy(), scene.bin_max.cpu().numpy()))


def _pack_scene_tables(scene, slot_src, meta, leaf_order, tri_mask,
                       roots) -> PackedScene:
    """Gather a Scene's bounds and triangles into the tables of one packed
    layout (slot_src, meta, leaf_order); roots: the table's entry rows."""
    k = scene.leaf_size
    dev = scene.device
    assert leaf_order.shape[0] == scene.num_leaves, \
        (leaf_order.shape[0], scene.num_leaves)
    tri_perm = (leaf_order[:, None] * k + np.arange(k)[None, :]).reshape(-1)
    perm = torch.as_tensor(tri_perm, device=dev)
    slot_src_t = torch.as_tensor(slot_src.astype(np.int32), device=dev)
    meta_t = torch.as_tensor(meta, device=dev)
    tri_v = scene.tri_v[perm]
    tri_prim = scene.tri_prim[perm]
    tri_mesh = scene.tri_mesh[perm]
    mask_p = None
    if tri_mask is not None:
        tri_mask = _check_mask(tri_mask)
        # soup order -> Morton-sorted order -> packed order.
        soup_of_sorted = scene.perm.cpu().numpy()
        sorted_mask = np.where(
            soup_of_sorted >= 0,
            tri_mask[np.clip(soup_of_sorted, 0, tri_mask.shape[0] - 1)], 0)
        mask_p = sorted_mask[tri_perm].astype(np.float64)
    return PackedScene(
        nodes=_gather_rows(scene.bin_min, scene.bin_max, scene.leaf_min,
                           scene.leaf_max, slot_src_t, meta_t),
        meta=meta_t,
        tris=_tri_rows(tri_v, tri_prim >= 0, mask_p, tri_mesh, tri_prim),
        tri_v=tri_v,
        tri_vidx=scene.tri_vidx[perm],
        tri_mesh=tri_mesh,
        tri_prim=tri_prim,
        slot_src=slot_src_t,
        tri_perm=perm.to(torch.int32),
        num_tris=scene.num_tris,
        leaf_size=k,
        depth=tree_depth(meta, roots),
    )


def pack_scene(scene, tri_mask=None) -> PackedScene:
    """Pack a built Scene for the packet kernel (on the scene's device).

    tri_mask: optional (num_tris,) per-triangle filter-mask bits in
    ORIGINAL soup order (24 bits used).  A trace with filter_mask=m tests
    only triangles with (tri_mask & m) != 0."""
    if scene.num_leaves == 1:
        slot_src = np.full((1, W), -1, np.int64)
        slot_src[0, 0] = -2  # leaf 0
    else:
        slot_src = _greedy_slots(*_scene_binary(scene))
    meta, leaf_order = _pack_meta(slot_src)
    return _pack_scene_tables(scene, slot_src, meta, leaf_order, tri_mask,
                              [0])


def pack_multiroot(scene, roots, tri_mask=None) -> PackedScene:
    """Pack a forest of disjoint subtrees of one Scene in a single BFS.

    roots: (R,) binary node ids (or leaf codes <= -2 for single-leaf
    subtrees, or -1 for EMPTY rows) whose subtrees are disjoint and
    jointly cover every leaf exactly once.  The packed entry row of root r
    is r.  tri_mask: as in pack_scene."""
    roots = np.asarray(roots, np.int64)
    slot_src = _greedy_slots(*_scene_binary(scene), root=roots)
    meta, leaf_order = _pack_meta(slot_src, root_rows=roots.shape[0])
    return _pack_scene_tables(scene, slot_src, meta, leaf_order, tri_mask,
                              np.arange(roots.shape[0]))


def pack_forest(scene, roots) -> tuple[PackedScene, np.ndarray]:
    """Pack a multi-root (merged-BLAS) Scene for the packet kernel, one
    BFS block per root, the blocks one after another.

    roots: binary root node ids in the merged space (one per BLAS).
    Returns (packed, packed_roots): packed_roots[b] is the packed row to
    start traversal at for BLAS b."""
    left, right, area = _scene_binary(scene)
    slot_parts, meta_parts, leaf_parts, packed_roots = [], [], [], []
    node_base = leaf_base = 0
    for r in np.asarray(roots, np.int64):
        ss = _greedy_slots(left, right, area, root=int(r))
        meta, leaf_order = _pack_meta(ss, node_base=node_base,
                                      leaf_base=leaf_base)
        packed_roots.append(node_base)
        node_base += ss.shape[0]
        leaf_base += leaf_order.shape[0]
        slot_parts.append(ss)
        meta_parts.append(meta)
        leaf_parts.append(leaf_order)
    packed_roots = np.asarray(packed_roots, np.int32)
    packed = _pack_scene_tables(
        scene, np.concatenate(slot_parts), np.concatenate(meta_parts),
        np.concatenate(leaf_parts), None, packed_roots)
    return packed, packed_roots


@dataclasses.dataclass
class BinaryRefitAux:
    """Refit mappings for a host-built binary tree (pack_binary_tree).

    A binned-SAH builder partitions triangles in place, so every binary
    node covers a contiguous run of the leaf sequence ordered by first
    triangle, the property Karras nodes get from the Morton sort.  The
    LBVH's range-query refit (builder/lbvh.py refit_ranges_flat) then
    applies as it is: these tensors carry each node's leaf-rank range and
    the fixed permutations between the three leaf numberings (rank: order
    of first triangle; lidx: order of binary node id, which slot_src
    uses; visit: block order of the packed triangle table).  Made once on
    the host by pack_binary_tree(return_refit_aux=True), which checks the
    contiguity."""

    rank_lo: torch.Tensor  # (Nn,) i32 first leaf rank under binary node
    rank_hi: torch.Tensor  # (Nn,) i32 last leaf rank (inclusive)
    visit_of_rank: torch.Tensor  # (nl,) i32 packed visit block of rank r
    visit_of_lidx: torch.Tensor  # (nl,) i32 packed visit block of lidx l

    @property
    def device(self) -> torch.device:
        return self.rank_lo.device


def refit_packed_binary(packed: PackedScene, aux: BinaryRefitAux,
                        new_tri_pos) -> PackedScene:
    """Refit a pack_binary_tree PackedScene to deformed vertices (same
    topology) on its device: the SAH counterpart of refit + repack_bounds.

    new_tri_pos: (T, 3, 3) vertices in ORIGINAL SOUP order (the
    pack_binary_tree tri_perm convention), an array or a tensor.  Only
    enqueues work: per-leaf bounds from the packed rows, the range-query
    levels, the row gathers.
    """
    scene_module.REFITS += 1
    with span("rtk.refit"):
        tri_pos = soup_tensor(new_tri_pos, packed.num_tris, packed.device)
        # Padding rows hold -1: they gather triangle 0 through the clamp and
        # are masked out of the bounds and the triangle table by `valid`.
        tri_v = tri_pos[packed.tri_perm.clamp(0, packed.num_tris - 1).long()]
        valid = packed.tri_perm >= 0
        k = packed.leaf_size
        nl = aux.visit_of_rank.shape[0]
        if tri_v.shape[0] != nl * k:
            raise ValueError(f"{tri_v.shape[0]} triangle rows for {nl} leaves "
                             f"of {k}")
        # Per-leaf bounds from the packed rows (visit order): each visit block
        # is k consecutive rows; padding rows enter the reduce as +/-inf.
        vmin = torch.where(valid[:, None, None], tri_v, float("inf"))
        vmax = torch.where(valid[:, None, None], tri_v, -float("inf"))
        lmin_visit = vmin.reshape(nl, k * 3, 3).amin(dim=1)
        lmax_visit = vmax.reshape(nl, k * 3, 3).amax(dim=1)
        if nl == 1:
            bmin, bmax = lmin_visit, lmax_visit
        else:
            by_rank = aux.visit_of_rank.long()
            bmin, bmax = refit_ranges_flat(aux.rank_lo, aux.rank_hi,
                                           lmin_visit[by_rank],
                                           lmax_visit[by_rank])
        by_lidx = aux.visit_of_lidx.long()
        nodes = _gather_rows(bmin, bmax, lmin_visit[by_lidx],
                             lmax_visit[by_lidx], packed.slot_src, packed.meta)
        mask_col = packed.tris[:, MASK_COL]  # the mask column rides along
        return dataclasses.replace(
            packed, nodes=nodes, tri_v=tri_v,
            tris=_tri_rows(tri_v, valid, mask_col, packed.tri_mesh,
                           packed.tri_prim))


def _binary_refit_aux(left, right, first, count, is_leaf, leaf_nodes,
                      roots, leaf_order, *, device) -> BinaryRefitAux:
    """BinaryRefitAux of a host-built binary tree (host NumPy; see the
    class).  Raises ValueError unless every internal node's children split
    its triangle range, the in-place-partition property the range-query
    refit needs."""
    nl = leaf_nodes.shape[0]
    tri_lo = np.where(is_leaf, first, 0)
    tri_hi = np.where(is_leaf, first + count, 0)
    # BFS levels of internal nodes (leaf roots contribute no levels).
    rts = roots[roots >= 0]
    levels = []
    frontier = rts[~is_leaf[rts]]
    while frontier.size:
        levels.append(frontier)
        ch = np.concatenate([left[frontier], right[frontier]])
        frontier = ch[~is_leaf[ch]]
    for f in reversed(levels):
        l, r = left[f], right[f]
        tri_lo[f] = np.minimum(tri_lo[l], tri_lo[r])
        tri_hi[f] = np.maximum(tri_hi[l], tri_hi[r])
    for f in levels:
        l, r = left[f], right[f]
        straddle = ((np.minimum(tri_lo[l], tri_lo[r]) == tri_lo[f])
                    & (np.maximum(tri_hi[l], tri_hi[r]) == tri_hi[f])
                    & ((tri_hi[l] == tri_lo[r]) | (tri_hi[r] == tri_lo[l])))
        if not straddle.all():
            raise ValueError(
                "binary tree is not an in-place partition (children do not "
                "split their parent's triangle range); refit aux requires "
                "a contiguous-range builder")
    leaf_firsts = first[leaf_nodes]
    rank_order = np.argsort(leaf_firsts, kind="stable")  # rank -> lidx
    sorted_firsts = leaf_firsts[rank_order]
    rank_lo = np.searchsorted(sorted_firsts, tri_lo).astype(np.int64)
    rank_hi = (np.searchsorted(sorted_firsts, tri_hi, side="left")
               - 1).astype(np.int64)
    if not ((rank_lo <= rank_hi).all() and (rank_hi < nl).all()):
        raise ValueError(
            "malformed binary tree: leaf-rank ranges are inconsistent "
            "(empty leaves or out-of-range triangle spans); refit aux "
            "cannot be derived")
    visit_of_lidx = np.empty(nl, np.int64)
    visit_of_lidx[leaf_order] = np.arange(nl)

    def i32(a):
        return torch.as_tensor(a.astype(np.int32), device=device)

    return BinaryRefitAux(rank_lo=i32(rank_lo), rank_hi=i32(rank_hi),
                          visit_of_rank=i32(visit_of_lidx[rank_order]),
                          visit_of_lidx=i32(visit_of_lidx))


def repack_reference(packed: PackedScene, scene) -> PackedScene:
    """repack_kernel's plain version on any device (the plain steps'
    repack): the vertices gathered through tri_perm, the node rows and the
    triangle table built again by eager ops."""
    tri_v = scene.tri_v[packed.tri_perm.long()]
    mask_col = packed.tris[:, MASK_COL]
    return dataclasses.replace(
        packed, tri_v=tri_v,
        nodes=_gather_rows(scene.bin_min, scene.bin_max, scene.leaf_min,
                           scene.leaf_max, packed.slot_src, packed.meta),
        tris=_tri_rows(tri_v, packed.tri_prim >= 0, mask_col,
                       packed.tri_mesh, packed.tri_prim))


def repack_kernel(packed: PackedScene, scene, lib=None) -> PackedScene:
    """repack_bounds on the card: one launch of csrc/refit.cu's rtk_repack
    on the current stream, with no host sync, equal bit for bit to
    repack_reference.  nodes, tris and tri_v are new tensors
    (torch.empty); the layout and the hit-assembly index tables are
    packed's.  lib: a loaded library to launch from (an AOT artifact's,
    utils/aot.py) instead of the one built from the sources.  Raises if
    the tensors are not on one card or the tables do not fit the scene."""
    global REPACK_LAUNCHES
    dev = packed.device
    if dev.type != "cuda":
        raise ValueError("repack_kernel takes tables on a CUDA device; the "
                         "plain version is repack_reference")
    nd, w = packed.slot_src.shape
    tp = packed.tri_perm.shape[0]
    i32, f32 = torch.int32, torch.float32
    n_bin, n_leaf = scene.bin_min.shape[0], scene.leaf_min.shape[0]
    rows = scene.tri_v.shape[0]
    for a, what, dtype, shape in (
            (packed.slot_src, "slot_src", i32, (nd, w)),
            (packed.meta, "meta", i32, (nd, 4)),
            (packed.tri_mesh, "tri_mesh", i32, (tp,)),
            (packed.tri_prim, "tri_prim", i32, (tp,)),
            (packed.tri_perm, "tri_perm", i32, (tp,)),
            (packed.tris, "tris", f32, (tp, TRI_ROW_F32)),
            (scene.bin_min, "scene.bin_min", f32, (n_bin, 3)),
            (scene.bin_max, "scene.bin_max", f32, (n_bin, 3)),
            (scene.leaf_min, "scene.leaf_min", f32, (n_leaf, 3)),
            (scene.leaf_max, "scene.leaf_max", f32, (n_leaf, 3)),
            (scene.tri_v, "scene.tri_v", f32, (rows, 3, 3))):
        library.check_tensor(a, what, dtype, shape, dev)
    if lib is None:
        lib = library.load_kernel()
    ins = [a.contiguous() for a in (
        packed.slot_src, packed.meta, scene.bin_min, scene.bin_max,
        scene.leaf_min, scene.leaf_max, packed.tri_perm, scene.tri_v,
        packed.tri_mesh, packed.tri_prim, packed.tris)]
    (slot_src, meta, bmin, bmax, lmin, lmax, tri_perm, scene_v, mesh, prim,
     old_tris) = (a.data_ptr() for a in ins)
    nodes = torch.empty((nd * w, NODE_ROW_I32), dtype=i32, device=dev)
    tris = torch.empty((tp, TRI_ROW_F32), dtype=f32, device=dev)
    tri_v = torch.empty((tp, 3, 3), dtype=f32, device=dev)
    library.launch(dev, "rtk_repack", lib.rtk_repack, slot_src, meta, nd, w,
                   bmin, bmax, n_bin, lmin, lmax, n_leaf, tri_perm, scene_v,
                   rows, mesh, prim, old_tris, tp, nodes.data_ptr(),
                   tris.data_ptr(), tri_v.data_ptr())
    REPACK_LAUNCHES += 1
    return dataclasses.replace(packed, nodes=nodes, tris=tris, tri_v=tri_v)


def repack_by(step, packed: PackedScene, scene) -> PackedScene:
    """repack_bounds through `step` (a Steps' repack, ops/packet_trace.py:
    an AOT artifact passes its own library's): the call counted in
    REPACKS, its body the span `rtk.repack`."""
    global REPACKS
    REPACKS += 1
    with span("rtk.repack"):
        return step(packed, scene)


def repack_bounds(packed: PackedScene, scene) -> PackedScene:
    """Refresh a PackedScene after refit(scene, ...) (same topology, new
    bounds and vertices), on the device: repack_kernel on a card,
    repack_reference on the CPU.  The layout (meta, slot_src, tri_perm,
    depth, branching) is reused, so stack_size is the same, and the mask
    column of the old triangle table is carried over, so a tri_mask
    survives the refit."""
    from rtk_tpu_torch.ops.packet_trace import front_steps  # imports us

    return repack_by(front_steps(packed.device).repack, packed, scene)


def pack_binary_tree(tri_v, left, right, first, count, box_lo, box_hi,
                     order, root, leaf_size: int, tri_vidx=None,
                     tri_mesh=None, tri_prim=None, tri_mask=None,
                     return_refit_aux: bool = False, branching: int = W,
                     device="cuda"):
    """Pack an arbitrary host-built binary BVH for the packet kernel.

    Feeds any binary topology (e.g. the C++ binned SAH via
    NativeOracle.export_tree) through the same greedy wide collapse as
    pack_scene.  left/right: child node id or -1 for leaves; first/count
    index into `order` (leaf triangle lists, <= leaf_size each); box_lo/hi:
    (Nn, 3) node bounds; root: the root node id.  tri_v: (T, 3, 3) soup;
    tri_perm holds original soup ids (pad -1).  return_refit_aux=True
    returns (packed, BinaryRefitAux) so refit_packed_binary can refit the
    tables on the device; that needs an in-place-partition topology, which
    the native binned SAH is, and raises ValueError otherwise.

    root may be an array of binary root ids whose subtrees are disjoint
    and jointly cover every leaf exactly once (a forest, e.g. per-BLAS SAH
    trees for the instanced path): the packed entry row of root r is then
    r (the pack_multiroot layout).

    branching: the node table's width, 8 or 16 (16 rows a node, the leaf
    mask shifted by 16 in the masks word).
    """
    if branching not in (8, 16):
        raise ValueError(f"branching must be 8 or 16, not {branching}")
    left = np.asarray(left, np.int64)
    right = np.asarray(right, np.int64)
    first = np.asarray(first, np.int64)
    count = np.asarray(count, np.int64)
    box_lo = np.asarray(box_lo, np.float32)
    box_hi = np.asarray(box_hi, np.float32)
    order = np.asarray(order, np.int64)
    k = leaf_size
    if count.size and count.max() > k:
        raise ValueError(f"leaf count {count.max()} exceeds leaf_size {k}")

    is_leaf = left < 0
    leaf_nodes = np.nonzero(is_leaf)[0]
    nl = leaf_nodes.shape[0]
    lidx = np.full(left.shape[0], -1, np.int64)
    lidx[leaf_nodes] = np.arange(nl)

    def mapped(child):
        c = np.clip(child, 0, None)
        return np.where(is_leaf[c], -(lidx[c] + 2), child)

    roots = np.asarray(root, np.int64).reshape(-1)
    roots_m = np.where(is_leaf[roots], -(lidx[roots] + 2), roots)
    forest = np.ndim(root) != 0
    slot_src = _greedy_slots(mapped(left), mapped(right),
                             _area(box_lo, box_hi),
                             root=roots_m if forest else int(roots_m[0]),
                             w=branching)
    meta, leaf_order = _pack_meta(slot_src,
                                  root_rows=roots.shape[0] if forest else 1)
    assert leaf_order.shape[0] == nl, (leaf_order.shape[0], nl)

    # (nl, k) triangle ids per leaf (pad -1), in leaf-visit order.
    tids = np.full((nl, k), -1, np.int64)
    col = np.arange(k)[None, :]
    fc_ = first[leaf_nodes][:, None]
    cn_ = count[leaf_nodes][:, None]
    take = col < cn_
    tids[take] = order[(fc_ + np.minimum(col, cn_ - 1))[take]]
    tri_ids = tids[leaf_order].reshape(-1)

    dev = torch.device(device)
    i32 = dict(dtype=torch.int32, device=dev)
    valid = torch.as_tensor(tri_ids >= 0, device=dev)
    gather = torch.as_tensor(np.where(tri_ids >= 0, tri_ids, 0), device=dev)
    tv = torch.as_tensor(np.asarray(tri_v, np.float32),
                         device=dev).reshape(-1, 3, 3)[gather]
    if tri_vidx is None:
        tvi = (gather[:, None] * 3 + torch.arange(3, device=dev)[None, :])
    else:
        tvi = torch.as_tensor(np.asarray(tri_vidx), device=dev)[gather]
    tm = (torch.zeros_like(gather) if tri_mesh is None
          else torch.as_tensor(np.asarray(tri_mesh), device=dev)[gather])
    tp_ = (gather if tri_prim is None
           else torch.as_tensor(np.asarray(tri_prim), device=dev)[gather])
    tp_ = torch.where(valid, tp_, -1).to(torch.int32)
    mask = None
    if tri_mask is not None:
        # Padding rows take triangle 0's bits, as rtk_tpu's table does.
        mask = _check_mask(tri_mask)[gather.cpu().numpy()].astype(np.float32)

    slot_src_t = torch.as_tensor(slot_src.astype(np.int32), device=dev)
    meta_t = torch.as_tensor(meta, device=dev)
    lo_t = torch.as_tensor(box_lo, device=dev)
    hi_t = torch.as_tensor(box_hi, device=dev)
    leaf_t = torch.as_tensor(leaf_nodes, device=dev)
    tm = tm.to(torch.int32)
    packed = PackedScene(
        nodes=_gather_rows(lo_t, hi_t, lo_t[leaf_t], hi_t[leaf_t],
                           slot_src_t, meta_t),
        meta=meta_t,
        tris=_tri_rows(tv, valid, mask, tm, tp_),
        tri_v=tv,
        tri_vidx=tvi.to(torch.int32),
        tri_mesh=tm,
        tri_prim=tp_,
        slot_src=slot_src_t,
        tri_perm=torch.as_tensor(np.where(tri_ids >= 0, tri_ids, -1),
                                 **i32),
        num_tris=int(np.asarray(tri_v).reshape(-1, 9).shape[0]),
        leaf_size=k,
        depth=tree_depth(meta, np.arange(roots.shape[0]), branching),
        branching=branching,
    )
    if not return_refit_aux:
        return packed
    return packed, _binary_refit_aux(left, right, first, count, is_leaf,
                                     leaf_nodes, roots, leaf_order,
                                     device=dev)

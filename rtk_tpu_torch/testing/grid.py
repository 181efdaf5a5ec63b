"""Macro-grid DDA tracing (rtk_tpu.testing.grid): the grid build and the
fused march.

The grid covers the scene with disjoint cells that a ray visits in strict
t order (Amanatides-Woo DDA), so a ray stops as soon as its best hit
precedes the current cell's exit.

  build: triangles are binned conservatively into the cells their AABB
    overlaps (a triangle may land in several cells), each cell's list is
    padded to whole leaf clusters, and ONE LBVH is built over the (cell,
    triangle) pairs with cell-prefixed local Morton keys, so every cell's
    range is exactly one subtree.  The subtrees are packed as a forest in
    one multi-root BFS; with march=True a second forest has one root row
    per cell (childless rows for empty cells), so a cell's root row is its
    id.
  march: one launch of the kernel's march instantiation (ops/packet_trace
    .py): every ray walks its own cell chain, traversing each cell's tree
    with its best hit carried, until the hit precedes the cell's exit.
    Hits come back in the flat table's slots.

Every host table build_grid makes is the same NumPy code as rtk_tpu's, and
its outputs are bit-equal to rtk_tpu's.  The rounds engine
(trace_packets_grid, calibrate_caps) is still to port.

Reference semantics preserved: nearest hit, open (min_t, max_t) window,
strict < tie (rtk.c:543-577); a triangle binned in several cells re-tests
at the same t and loses the strict-< tie, so records match the flat
engine's.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from rtk_tpu_torch.builder.lbvh import leaf_code
from rtk_tpu_torch.config import BuildConfig
from rtk_tpu_torch.ops.packet_trace import (MarchGrid, march_entry,
                                            packet_march,
                                            packet_march_reference)
from rtk_tpu_torch.scene import Scene, build_from_soup
from rtk_tpu_torch.trace.packed import (PackedScene, pack_multiroot,
                                        pack_scene)
from rtk_tpu_torch.types import PacketHits, Rays

# Bits a component of a ray's direction inside its octant takes in the
# march's grouping key (PERF.md section 6: finer keys lost, coarser ones
# grouped less).
DIR_BITS = 3


@dataclasses.dataclass
class GridScene:
    """Macro-grid acceleration structure (product of build_grid).

    cells: forest-packed per-cell trees (one root per occupied cell).
    flat: the ordinary packed scene (its tables carry the hit records).
    rank: (prod(dims),) i32: occupied cell -> rank (>= 0); empty cell ->
      minus the chebyshev distance to the nearest occupied cell (the rounds
      engine's empty-space leap field).
    cells_to_flat: (Tp_cells,) i32 flat-table slot per cells-table slot.
    cells_march / march_to_flat: with build_grid(march=True), the forest
      with one root row per cell (row == cell id) and its slot map.
    march_occ: with build_grid(march=True), (ceil(cells / 32),) i32 words
      with bit c set where cell c is occupied: the march kernel steps over
      the other cells without reading their childless root rows.
    """

    cells: PackedScene
    flat: PackedScene
    rank: torch.Tensor
    cells_to_flat: torch.Tensor
    grid_lo: torch.Tensor  # (3,) f32
    cell_size: torch.Tensor  # (3,) f32
    dims: tuple
    n_occ: int
    cells_march: PackedScene | None = None
    march_to_flat: torch.Tensor | None = None
    march_occ: torch.Tensor | None = None

    @property
    def device(self) -> torch.device:
        return self.rank.device


def _interleave6(q: np.ndarray) -> np.ndarray:
    """Spread 6-bit ints so bits land 3 apart (host helper)."""
    q = q.astype(np.uint32)
    q = (q | (q << 8)) & 0x0300F
    q = (q | (q << 4)) & 0x030C3
    q = (q | (q << 2)) & 0x09249
    return q


def choose_dims(extent: np.ndarray, n_tris: int, max_cells: int = 4096,
                target: int = 48) -> tuple:
    """Per-axis cell counts: roughly cubical cells, ~target tris/cell,
    <= max_cells total, each axis in [1, 32]."""
    want = min(max_cells, max(1, n_tris // target))
    ext = np.maximum(extent, 1e-30)
    base = (want / float(ext.prod())) ** (1.0 / 3.0)
    dims = np.maximum(1, np.floor(ext * base)).astype(np.int64)
    dims = np.minimum(dims, 32)
    while dims.prod() > max_cells:
        dims[dims.argmax()] -= 1
    return tuple(int(x) for x in dims)


def _host(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _chebyshev_rank(dims, ucell, n_occ) -> np.ndarray:
    """Occupied cell -> its rank; empty cell -> minus its chebyshev
    distance to the nearest occupied cell (at least 1, at most 255)."""
    dx, dy, dz = dims
    occ3 = np.zeros((dx, dy, dz), bool)
    occ3.reshape(-1)[ucell] = True
    big = np.iinfo(np.int32).max // 2
    dist = np.where(occ3, 0, big).astype(np.int64)
    for _ in range(int(np.sum(~occ3) and max(dims))):
        p = np.pad(dist, 1, constant_values=big)
        m = dist
        for sx_ in (0, 1, 2):
            for sy_ in (0, 1, 2):
                for sz_ in (0, 1, 2):
                    if sx_ == 1 and sy_ == 1 and sz_ == 1:
                        continue
                    m = np.minimum(
                        m, p[sx_:sx_ + dx, sy_:sy_ + dy, sz_:sz_ + dz] + 1)
        if np.array_equal(m, dist):
            break
        dist = m
    dist = np.minimum(dist, 255)
    rank_tbl = np.full(dx * dy * dz, -1, np.int32)
    rank_tbl[ucell] = np.arange(n_occ, dtype=np.int32)
    empty = rank_tbl < 0
    rank_tbl[empty] = -np.maximum(dist.reshape(-1)[empty], 1).astype(
        np.int32)
    return rank_tbl


def build_grid(tri_pos, tri_vidx=None, tri_mesh=None, tri_prim=None,
               config: BuildConfig = BuildConfig(), dims=None,
               max_cells: int = 4096, flat: PackedScene | None = None,
               scene: Scene | None = None, tri_mask=None,
               march: bool = False, device="cuda") -> GridScene:
    """Build the macro-grid structure from a triangle soup on `device`.

    flat/scene: reuse an ordinary build of the SAME soup (same config) for
    the record tables; built here when not given.  tri_mask: optional (T,)
    per-triangle filter bits in soup order (24 bits, pack_scene
    semantics), packed into the per-cell tables and the flat tables; a
    caller-supplied `flat` must carry the same mask.  march=True also
    packs the one-root-per-cell forest that trace_packets_march needs.
    """
    tp = np.asarray(_host(tri_pos), np.float32).reshape(-1, 3, 3)
    T = tp.shape[0]
    k = config.leaf_size
    tlo = tp.min(axis=1)
    thi = tp.max(axis=1)
    glo = tlo.min(axis=0)
    ghi = thi.max(axis=0)
    ext = ghi - glo
    pad = np.maximum(ext, 1.0) * 1e-5
    glo = glo - pad
    ext = ext + 2 * pad
    if dims is None:
        dims = choose_dims(ext, T, max_cells=max_cells)
    dims = tuple(int(d) for d in dims)
    dx, dy, dz = dims
    cs = ext / np.array(dims, np.float64)

    # Conservative tri->cell assignment (AABB overlap; duplicates are
    # exact re-tests, never wrong results).
    c0 = np.clip(((tlo - glo) / cs).astype(np.int64), 0,
                 np.array(dims) - 1)
    c1 = np.clip(((thi - glo) / cs).astype(np.int64), 0,
                 np.array(dims) - 1)
    cnt3 = c1 - c0 + 1
    counts = cnt3.prod(axis=1)
    total = int(counts.sum())
    rep = np.repeat(np.arange(T, dtype=np.int64), counts)
    offs = np.concatenate([[0], np.cumsum(counts)[:-1]])
    rank_in = np.arange(total, dtype=np.int64) - offs[rep]
    nz = cnt3[rep, 2]
    ny = cnt3[rep, 1]
    oz = rank_in % nz
    r2 = rank_in // nz
    oy = r2 % ny
    ox = r2 // ny
    cx = c0[rep, 0] + ox
    cy = c0[rep, 1] + oy
    cz = c0[rep, 2] + oz
    cell = (cx * dy + cy) * dz + cz

    # Group pairs by cell; pad each cell to whole leaf clusters so cell
    # boundaries align with cluster boundaries (pads duplicate the cell's
    # last pair: real triangles, harmless re-tests).
    order = np.argsort(cell, kind="stable")
    cell_s = cell[order]
    ucell, start, ccount = np.unique(cell_s, return_index=True,
                                     return_counts=True)
    n_occ = ucell.shape[0]
    pad_per = (-ccount) % k
    padded = ccount + pad_per
    ptot = int(padded.sum())
    pcum = np.concatenate([[0], np.cumsum(padded)])
    grp = np.repeat(np.arange(n_occ, dtype=np.int64), padded)
    pos_in = np.arange(ptot, dtype=np.int64) - pcum[grp]
    src_row = start[grp] + np.minimum(pos_in, ccount[grp] - 1)
    pair_tri = rep[order][src_row]  # original tri id per padded pair

    # Cell-prefixed local Morton keys: the cell's rank in the top 14 bits
    # makes every cell an exact Karras subtree of the ONE merged build.
    cell3 = np.stack([ucell // (dy * dz), (ucell // dz) % dy, ucell % dz],
                     axis=1)[grp]
    cent = tp[pair_tri].mean(axis=1)
    nrm = np.clip((cent - (glo + cell3 * cs)) / cs, 0.0, 0.999999)
    q = (nrm * 64.0).astype(np.uint32)
    local = (_interleave6(q[:, 0]) << 2) | (_interleave6(q[:, 1]) << 1) \
        | _interleave6(q[:, 2])
    if n_occ > (1 << 14):
        raise ValueError(
            f"{n_occ} occupied cells exceeds the 16384-cell key budget; "
            "use coarser dims= (or the default max_cells heuristic)")
    # Keys reach bit 31: int64 on the way into the build, never int32.
    codes = (grp << 18) | local.astype(np.int64)

    # Per-pair record arrays (records report the ORIGINAL soup entities).
    if tri_vidx is None:
        pv = (pair_tri[:, None] * 3
              + np.arange(3, dtype=np.int64)[None, :]).astype(np.int32)
    else:
        pv = np.asarray(_host(tri_vidx), np.int32)[pair_tri]
    pm = (np.zeros(ptot, np.int32) if tri_mesh is None
          else np.asarray(_host(tri_mesh), np.int32)[pair_tri])
    pp = (pair_tri.astype(np.int32) if tri_prim is None
          else np.asarray(_host(tri_prim), np.int32)[pair_tri])

    merged = build_from_soup(tp[pair_tri], pv, pm, pp, config=config,
                             codes=codes, device=device)

    # Per-cell subtree roots: cell c covers clusters [cl0, cl1]; with >= 2
    # clusters that range is exactly one Karras node (cell bits split
    # first); a single cluster is the leaf itself.
    ccl = padded // k
    ccum = np.concatenate([[0], np.cumsum(ccl)])
    if merged.num_leaves == 1:
        roots = np.array([leaf_code(0)], np.int64)
    else:
        rangemap = {(int(lo), int(hi)): i for i, (lo, hi) in enumerate(
            zip(_host(merged.bin_lo), _host(merged.bin_hi)))}
        roots = np.empty(n_occ, np.int64)
        for r in range(n_occ):
            lo, hi = int(ccum[r]), int(ccum[r + 1]) - 1
            roots[r] = leaf_code(lo) if lo == hi else rangemap[(lo, hi)]
    # The merged build's "soup" is the padded pair list, so the mask
    # enters pack_multiroot in pair order.
    mask_pairs = (None if tri_mask is None
                  else np.asarray(_host(tri_mask), np.int64)[pair_tri])
    cells_packed = pack_multiroot(merged, roots, tri_mask=mask_pairs)
    cells_march = occ_words = None
    if march:
        occ_words = np.zeros(-(-(dx * dy * dz) // 32), np.uint32)
        np.bitwise_or.at(occ_words, ucell >> 5,
                         np.left_shift(np.uint32(1),
                                       (ucell & 31).astype(np.uint32)))
        # One root per CELL (empty cells -1 -> childless rows): the march
        # reaches a cell's tree at row == cell id.
        roots_cells = np.full(dx * dy * dz, -1, np.int64)
        roots_cells[ucell] = roots
        cells_march = pack_multiroot(merged, roots_cells,
                                     tri_mask=mask_pairs)

    if flat is None:
        if scene is None:
            scene = build_from_soup(tp, tri_vidx, tri_mesh, tri_prim,
                                    config=config, device=device)
        flat = pack_scene(scene, tri_mask=tri_mask)

    # cells-table slot -> flat-table slot (for record unification).
    flat_sorted_of_slot = _host(flat.tri_perm).astype(np.int64)
    # flat: packed slot -> sorted slot -> original soup id.  A caller's
    # Scene gives the soup ids (flat.tri_prim is the per-MESH index).
    if scene is not None:
        flat_scene_perm = _host(scene.perm).astype(np.int64)
        orig_of_flat = np.where(
            flat_sorted_of_slot >= 0,
            flat_scene_perm[np.clip(flat_sorted_of_slot, 0, None)], -1)
    else:
        if tri_prim is not None or tri_mesh is not None:
            raise ValueError(
                "build_grid(flat=...) with custom tri_prim/tri_mesh "
                "needs scene= too (flat.tri_prim holds per-mesh prim "
                "ids, not soup ids)")
        orig_of_flat = _host(flat.tri_prim).astype(np.int64)
    flat_of_orig = np.full(T, -1, np.int64)
    valid = orig_of_flat >= 0
    flat_of_orig[orig_of_flat[valid]] = np.nonzero(valid)[0]
    # cells packed slot -> merged sorted slot -> pair row -> original
    # triangle -> flat slot.
    merged_perm = _host(merged.perm).astype(np.int64)

    def c2f_of(pack):
        cells_sorted = _host(pack.tri_perm).astype(np.int64)
        cells_pair = np.where(
            cells_sorted >= 0,
            merged_perm[np.clip(cells_sorted, 0, None)], -1)
        cells_orig = np.where(cells_pair >= 0,
                              pair_tri[np.clip(cells_pair, 0, None)], -1)
        return np.where(cells_orig >= 0,
                        flat_of_orig[np.clip(cells_orig, 0, None)], -1)

    dev = flat.device

    def i32(a):
        return torch.as_tensor(a.astype(np.int32), device=dev)

    return GridScene(
        cells=cells_packed,
        flat=flat,
        rank=i32(_chebyshev_rank(dims, ucell, n_occ)),
        cells_to_flat=i32(c2f_of(cells_packed)),
        grid_lo=torch.as_tensor(glo.astype(np.float32), device=dev),
        cell_size=torch.as_tensor(cs.astype(np.float32), device=dev),
        dims=dims,
        n_occ=n_occ,
        cells_march=cells_march,
        march_to_flat=(None if cells_march is None
                       else i32(c2f_of(cells_march))),
        march_occ=(None if occ_words is None
                   else torch.as_tensor(occ_words.view(np.int32), device=dev)),
    )


def build_grid_from_scene(scene: Scene, packed: PackedScene | None = None,
                          **kw) -> GridScene:
    """Build the macro-grid structure from an already-built Scene, on its
    device, with its packed tables as the record tables (no second LBVH
    build of the same soup).  kw: build_grid options (dims, tri_mask,
    march, ...); a caller-supplied `packed` must carry the same
    tri_mask."""
    perm = _host(scene.perm).astype(np.int64)
    valid = perm >= 0
    T = scene.num_tris
    pos = np.empty((T, 3, 3), np.float32)
    vidx = np.empty((T, 3), np.int32)
    mesh = np.empty((T,), np.int32)
    prim = np.empty((T,), np.int32)
    pos[perm[valid]] = _host(scene.tri_v)[valid]
    vidx[perm[valid]] = _host(scene.tri_vidx)[valid]
    mesh[perm[valid]] = _host(scene.tri_mesh)[valid]
    prim[perm[valid]] = _host(scene.tri_prim)[valid]
    cfg = BuildConfig(branching=scene.branching, leaf_size=scene.leaf_size)
    if packed is None:
        packed = pack_scene(scene)
    return build_grid(pos, vidx, mesh, prim, config=cfg, flat=packed,
                      scene=scene, device=scene.device, **kw)


def march_batch(grid: GridScene, rays: Rays):
    """The march's input as trace_packets_march hands it to the kernel ->
    (MarchGrid, (8, N) ray rows, idx): rows grouped by (entry cell,
    direction octant), as rtk_tpu's grouping sort (testing/grid.py:862-
    893) groups them, and within a group by the direction inside the
    octant (|dx| and |dy| over |dx| + |dy| + |dz|, in DIR_BITS bits each),
    so the rays of a warp walk similar cell chains; rays that miss the
    grid last; row j is the caller's ray idx[j].  The order is no output:
    each ray's march is the same wherever it lies."""
    if grid.cells_march is None:
        raise ValueError("trace_packets_march needs build_grid(march=True)")
    if rays.device != grid.device:
        raise ValueError(f"rays on {rays.device}, grid on {grid.device}")
    mg = MarchGrid.of(grid.dims, grid.grid_lo, grid.cell_size,
                      occ=grid.march_occ)
    comps = torch.cat([rays.origin.T, rays.direction.T, rays.min_t[None],
                       rays.max_t[None]]).to(torch.float32)
    live, cell, *_ = march_entry(comps, mg)
    _, ny, nz = mg.dims
    d = rays.direction
    octant = ((d[:, 0] >= 0).long() * 4 + (d[:, 1] >= 0).long() * 2
              + (d[:, 2] >= 0).long())
    a = d.abs()
    s = a.sum(dim=1).clamp_min(1e-30)
    q = [((a[:, k] / s) * (1 << DIR_BITS)).long().clamp(0, (1 << DIR_BITS) - 1)
         for k in (0, 1)]
    key = (((((cell[0] * ny + cell[1]) * nz + cell[2]) << 3) | octant)
           << 2 * DIR_BITS) | (q[0] << DIR_BITS) | q[1]
    key = torch.where(live, key, torch.iinfo(torch.int64).max)
    idx = torch.sort(key, stable=True).indices
    return mg, comps[:, idx].contiguous(), idx


def trace_packets_march(grid: GridScene, rays: Rays, mode: str = "closest",
                        watertight: bool = True,
                        interpret: bool | None = None, pkt: int = 512,
                        filter_mask: int | None = None, stats: bool = False,
                        plain: bool = False):
    """Trace a ray batch with the fused grid march -> PacketHits (and, with
    stats=True, the (5, N) per-ray counts summed over each ray's cells,
    in the caller's order).

    Needs build_grid(march=True).  Same hit-record contract as
    trace_packets; exact by construction: every ray traverses its own
    cell chain until its best hit precedes the current cell's exit.  Rays
    are grouped first (march_batch); hits return in the caller's order,
    in the flat table's slots.  plain=True runs the march's plain PyTorch
    version on any device.  interpret and pkt select the TPU kernel's
    schedule and have no effect.
    """
    if mode not in ("closest", "any"):
        raise ValueError(f"unknown mode {mode!r}")
    mg, comps, idx = march_batch(grid, rays)
    cm = grid.cells_march
    run = packet_march_reference if plain else packet_march
    out = run(cm.nodes, cm.tris, comps, leaf_size=cm.leaf_size,
              stack_size=cm.stack_size, grid=mg,
              mode=mode, watertight=watertight,
              qmask=None if filter_mask is None
              else int(filter_mask) & 0xFFFFFF, stats=stats)

    def unsort(a):
        out_ = torch.empty_like(a)
        out_[..., idx] = a
        return out_

    t, u, v, slot = (unsort(a) for a in out[:4])
    hit = slot >= 0
    slot = torch.where(hit, grid.march_to_flat[slot.clamp_min(0).long()], -1)
    zero = torch.zeros((), device=t.device)
    hits = PacketHits(
        hit=hit, t=t, u_k=torch.where(hit, u, zero),
        v_k=torch.where(hit, v, zero), slot=slot, origin=rays.origin,
        direction=rays.direction, tri_v=grid.flat.tri_v,
        tri_vidx=grid.flat.tri_vidx, tri_mesh=grid.flat.tri_mesh,
        tri_prim=grid.flat.tri_prim)
    return (hits, unsort(out[4])) if stats else hits

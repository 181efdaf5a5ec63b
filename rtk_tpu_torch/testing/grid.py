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
  rounds (trace_packets_grid, Tracer(engine="grid")): per round, leap
    over empty cells, group the live rays by cell, launch the kernel's
    roots variant once with each ray's cell root, retire finished rays and
    step the rest one cell; a full-tree residual keeps the result exact
    under the round budget.  Every round has a fixed row count, so the
    rounds make no host sync.

Every host table build_grid makes is the same NumPy code as rtk_tpu's, and
its outputs are bit-equal to rtk_tpu's.

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
from rtk_tpu_torch.ops.intersect import intersect_triangles, ray_shear
from rtk_tpu_torch.ops.packet_trace import (_BIG, MarchGrid, _crcp,
                                            _trace_rooted, front_steps,
                                            march_entry, trace_packets,
                                            trace_packets_reference,
                                            unsort_reference)
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
    out = front_steps(comps.device, plain).march(
        cm.nodes, cm.tris, comps, leaf_size=cm.leaf_size,
        stack_size=cm.stack_size, grid=mg, mode=mode, watertight=watertight,
        qmask=None if filter_mask is None else int(filter_mask) & 0xFFFFFF,
        stats=stats)
    out = unsort_reference(out, idx)
    t, u, v, slot = out[:4]
    hit = slot >= 0
    slot = torch.where(hit, grid.march_to_flat[slot.clamp_min(0).long()], -1)
    zero = torch.zeros((), device=t.device)
    hits = PacketHits(
        hit=hit, t=t, u_k=torch.where(hit, u, zero),
        v_k=torch.where(hit, v, zero), slot=slot, origin=rays.origin,
        direction=rays.direction, tri_v=grid.flat.tri_v,
        tri_vidx=grid.flat.tri_vidx, tri_mesh=grid.flat.tri_mesh,
        tri_prim=grid.flat.tri_prim)
    return (hits, out[4]) if stats else hits


# ---------------------------------------------------------------------------
# The rounds engine: one rooted kernel launch per DDA step of the live rays
# ---------------------------------------------------------------------------

def _dda_axes(grid: GridScene, o, d):
    """Per-axis ray constants of the DDA: (lo, cs, clamped reciprocal, step
    +-1, t across one cell) for x, y, z, in the reference's f32 arithmetic
    (rtk_tpu/testing/grid.py:340-343, :398-402)."""
    lo, cs = grid.grid_lo, grid.cell_size  # read on the device: no sync
    rcp = [_crcp(d[:, a]) for a in range(3)]
    step = [torch.where(d[:, a] >= 0, 1, -1) for a in range(3)]
    tdel = [cs[a] * rcp[a].abs() for a in range(3)]
    return lo, cs, rcp, step, tdel


def _boundary_t(lo, cs, o, d, rcp, ia, a):
    """t at which the ray crosses the boundary ahead of cell index ia on
    axis a: (lo + (ia + (d >= 0)) * cs - o) * rcp."""
    nb = lo[a] + (ia + (d[:, a] >= 0).to(ia.dtype)).to(torch.float32) * cs[a]
    return (nb - o[:, a]) * rcp[a]


def _grid_far(grid: GridScene, lo, o, rcp):
    """The t at which each ray leaves the grid box (the near/far slab test
    of the DDA init, far side)."""
    hi = [lo[a] + grid.cell_size[a] * float(grid.dims[a]) for a in range(3)]
    near = torch.full_like(rcp[0], -_BIG)
    far = torch.full_like(rcp[0], _BIG)
    for a in range(3):
        t0 = (lo[a] - o[:, a]) * rcp[a]
        t1 = (hi[a] - o[:, a]) * rcp[a]
        near = torch.maximum(near, torch.minimum(t0, t1))
        far = torch.minimum(far, torch.maximum(t0, t1))
    return near, far


def _advance(grid: GridScene, ijk, tm, mask, step, tdel):
    """One DDA step where mask, across the nearest boundary (ties x, y, z)
    -> (ijk, tm, the rays the step took out of the grid)."""
    mx = (tm[0] <= tm[1]) & (tm[0] <= tm[2])
    my = ~mx & (tm[1] <= tm[2])
    mz = ~mx & ~my
    new_ijk, new_tm = [], []
    out = torch.zeros_like(mask)
    for a, m in enumerate((mx, my, mz)):
        i2 = ijk[a] + torch.where(m, step[a], 0)
        out = out | (i2 < 0) | (i2 >= grid.dims[a])
        new_ijk.append(torch.where(mask, i2, ijk[a]))
        new_tm.append(torch.where(mask, tm[a] + torch.where(m, tdel[a], 0.0),
                                  tm[a]))
    return new_ijk, new_tm, mask & out


def _cell_of(grid: GridScene, ijk):
    _, dy, dz = grid.dims
    return (ijk[0] * dy + ijk[1]) * dz + ijk[2]


def _ijk_of(grid: GridScene, cell):
    _, dy, dz = grid.dims
    safe = cell.clamp_min(0)
    return [safe // (dy * dz), (safe // dz) % dy, safe % dz]


def _pack_cell(grid: GridScene, ijk, done, abort):
    """>= 0 marching; -1 finished for good; -2 aborted (the final
    full-tree residual covers it)."""
    return torch.where(abort, -2, torch.where(done, -1, _cell_of(grid, ijk)))


def _grid_round(grid: GridScene, st, *, unit, skips, mode, watertight,
                filter_mask, steps):
    """One round over the state rows `st` (dict of equal-length tensors):
    empty-space leaps, grouping by cell rank, one rooted launch, retire and
    advance (rtk_tpu/testing/grid.py:384-630).  Fixed shapes throughout:
    no host sync.  -> (new state, (3,) int32 [rows the launch traced live,
    rows still marching after, rows aborted])."""
    dx, dy, dz = grid.dims
    n_cells = dx * dy * dz
    n_occ = grid.n_occ
    o, d = st["o"], st["d"]
    cell = st["cell"]
    abort = cell == -2
    done = cell == -1
    marching = cell >= 0
    ijk = _ijk_of(grid, cell)
    lo, cs, rcp, step, tdel = _dda_axes(grid, o, d)
    tm = [_boundary_t(lo, cs, o, d, rcp, ijk[a], a) for a in range(3)]

    # Empty-space leaps: the rank table holds minus the chebyshev distance
    # to the nearest occupied cell for an empty cell, so one lookup serves
    # occupancy and the length of the leap.
    tmin3 = torch.minimum(tdel[0], torch.minimum(tdel[1], tdel[2]))
    _, far = _grid_far(grid, lo, o, rcp)
    best_t = st["best_t"]
    safe = cell.clamp_min(0)
    for _ in range(skips):
        rank = grid.rank[safe.clamp_max(n_cells - 1)]
        exit_t = torch.minimum(tm[0], torch.minimum(tm[1], tm[2]))
        emp = marching & (rank < 0)
        fin = emp & (exit_t >= best_t)  # marched past any useful t
        done = done | fin
        marching = marching & ~fin
        emp = emp & ~fin
        dlp = (-rank).to(torch.float32)
        # d == 1: the adjacent cell may be occupied; take the exact DDA
        # step (a re-sampled position could overshoot a clipped corner).
        near = emp & (dlp < 1.5)
        ijk, tm, leftg = _advance(grid, ijk, tm, near, step, tdel)
        done = done | leftg
        marching = marching & ~leftg
        emp = emp & ~leftg
        # d >= 2: every cell within chebyshev d - 1 is empty, so landing
        # (d - 2) cell widths past the exit (plus a nudge) stays in empty
        # space, and re-sampling the position there skips no geometry.
        leap = emp & ~near
        t_new = (exit_t + torch.clamp_min(dlp - 2.0, 0.0) * tmin3
                 + 1e-4 * tmin3)
        leftg = leap & (t_new >= far)
        done = done | leftg
        marching = marching & ~leftg
        leap = leap & ~leftg
        oob = torch.zeros_like(emp)
        new_ijk, new_tm = [], []
        for a in range(3):
            pa = o[:, a] + d[:, a] * t_new
            ia = torch.floor((pa - lo[a]) / cs[a]).to(torch.int64)
            oob = oob | (ia < 0) | (ia >= grid.dims[a])
            ia = ia.clamp(0, grid.dims[a] - 1)
            new_ijk.append(ia)
            new_tm.append(_boundary_t(lo, cs, o, d, rcp, ia, a))
        leftg = leap & oob
        done = done | leftg
        marching = marching & ~leftg
        leap = leap & ~leftg
        ijk = [torch.where(leap, new_ijk[a], ijk[a]) for a in range(3)]
        tm = [torch.where(leap, new_tm[a], tm[a]) for a in range(3)]
        safe = _cell_of(grid, ijk).clamp(0, n_cells - 1)

    rank = grid.rank[safe]
    # Still in an empty cell after the skip budget: parked for the
    # residual rather than stalled.
    stuck = marching & (rank < 0)
    abort = abort | stuck
    marching = marching & ~stuck
    key = torch.where(marching, rank, n_occ)

    # Group by cell rank (a stable sort; every ray carries its own root,
    # so no cell is padded to whole packets) and launch once.
    st = dict(st, cell=_pack_cell(grid, ijk, done, abort))
    order = torch.sort(key, stable=True).indices
    st = {k: v[order] for k, v in st.items()}
    key = key[order]
    o, d, best_t = st["o"], st["d"], st["best_t"]
    cell = st["cell"]
    abort = cell == -2
    done = cell == -1
    marching = cell >= 0
    h = _trace_rooted(
        steps, grid.cells,
        Rays(o, d, st["mint"], torch.where(marching, best_t, 0.0)),
        key.clamp_max(n_occ - 1).to(torch.int32), mode=mode,
        watertight=watertight, filter_mask=filter_mask, pkt=unit)
    live_rows = marching.sum()
    improved = h.slot >= 0
    best_t = torch.where(improved, h.t, best_t)
    best_s = torch.where(improved, h.slot, st["best_s"])

    # Retire (the best hit precedes the cell's exit; any-hit: any hit) or
    # take one DDA step; leaving the grid finishes the ray.
    ijk = _ijk_of(grid, cell)
    lo, cs, rcp, step, tdel = _dda_axes(grid, o, d)
    tm = [_boundary_t(lo, cs, o, d, rcp, ijk[a], a) for a in range(3)]
    exit_t = torch.minimum(tm[0], torch.minimum(tm[1], tm[2]))
    fin = marching & (best_t <= exit_t)
    if mode == "any":
        fin = fin | (marching & (best_s >= 0))
    done = done | fin
    marching = marching & ~fin
    ijk, tm, left = _advance(grid, ijk, tm, marching, step, tdel)
    done = done | left
    marching = marching & ~left
    st.update(best_t=best_t, best_s=best_s,
              cell=_pack_cell(grid, ijk, done, abort))
    row = torch.stack([live_rows, marching.sum(), abort.sum()]).to(
        torch.int32)
    return st, row


def calibrate_caps(grid: GridScene, sample: Rays, rounds: int = 8,
                   skips: int = 3, unit: int = 128, slack: float = 1.15,
                   **kw) -> tuple:
    """A shrinking per-round row capacity schedule from one profiled trace
    of a representative batch (rtk_tpu/testing/grid.py:747-767, the same
    formula): round r + 1 needs about marching_r * slack rows (plus the
    reference's n_occ * unit of packet padding, kept so that the same
    counts give the same tuple).  Rays a too-small cap strands go to the
    exactness residual, never lost: a stale calibration costs speed, not
    accuracy.  One host sync reads the counts."""
    _, (cnts, _) = trace_packets_grid(grid, sample, rounds=rounds,
                                      skips=skips, unit=unit,
                                      debug_counts=True, **kw)
    marching = cnts[:, 1].tolist()
    pad = grid.n_occ * unit
    return tuple([2 ** 31 - 1]
                 + [int(m * slack) + pad for m in marching[:-1]])


def trace_packets_grid(grid: GridScene, rays: Rays, mode: str = "closest",
                       watertight: bool = True, interpret: bool = False,
                       rounds: int = 10, skips: int = 3, unit: int = 128,
                       caps=None, filter_mask: int | None = None,
                       debug_counts: bool = False, lesion: str = "",
                       sort_mode: str = "multi", plain: bool = False):
    """Trace a ray batch by marching the macro-grid in rounds -> PacketHits
    in the flat table's slots (and, with debug_counts, ((rounds, 3) int32
    [rows traced live, rows marching after, rows aborted], the residual's
    live count), both device tensors).

    The rounds engine of rtk_tpu/testing/grid.py:335-704.  Each ray enters
    the grid (the DDA init); each round leaps over empty cells through the
    rank table, groups the live rays by cell rank, launches the kernel's
    roots variant once with each ray's cell root, keeps improvements,
    retires rays whose best hit precedes their cell's exit and steps the
    rest one cell.  Rays still marching after `rounds` rounds, or parked
    by the skip budget or a cap, finish on the full tree (the exactness
    residual), and each winner's u, v come from one re-test of its
    triangle (ops/intersect.py), as in the reference.  Same hit-record
    contract as trace_packets.

    Every round has a fixed row count, so no round makes a host sync; the
    TPU's padding of each cell to whole packets (and the aborts of rays
    whose packet root is another cell's) has no counterpart, since every
    thread carries its own root.  caps: per-round row capacities (as
    calibrate_caps gives them; the last one repeats): round r traces the
    first caps[r] rows of the grouped state, and rays beyond it stay live
    for the residual.  The reference rounds each cap up to whole blocks of
    8 * unit rows, which a thread per ray does not need.  unit is the
    packet width the reference passes its launches (pkt, checked as
    there).  interpret,
    lesion and sort_mode pick the TPU program's schedule and probes and
    have no effect.  plain=True runs the rounds and the residual through
    the kernel's plain version on any device.
    """
    if mode not in ("closest", "any"):
        raise ValueError(f"unknown mode {mode!r}")
    if rays.device != grid.device:
        raise ValueError(f"rays on {rays.device}, grid on {grid.device}")
    n = rays.count
    dev = rays.device
    steps = front_steps(dev, plain)
    if caps is None:
        caps = (n,) * rounds
    else:
        caps = tuple(min(int(c), n) for c in caps)
        caps = (caps + (caps[-1],) * (rounds - len(caps)))[:rounds]
    o = rays.origin.to(torch.float32)
    d = rays.direction.to(torch.float32)
    mint = rays.min_t.to(torch.float32)
    maxt = rays.max_t.to(torch.float32)

    # DDA init: grid entry, first cell (rtk_tpu/testing/grid.py:353-373).
    lo, cs, rcp, _, _ = _dda_axes(grid, o, d)
    near, far = _grid_far(grid, lo, o, rcp)
    s0 = torch.clamp_min(near, 0.0)
    done = (near > far) | (far < 0.0) | (maxt <= mint)
    ijk = [torch.floor((o[:, a] + d[:, a] * s0 - lo[a]) / cs[a]).to(
        torch.int64).clamp(0, grid.dims[a] - 1) for a in range(3)]
    st = {"idx": torch.arange(n, device=dev), "o": o, "d": d, "mint": mint,
          "best_t": maxt, "best_s": torch.full((n,), -1, dtype=torch.int32,
                                               device=dev),
          "cell": _pack_cell(grid, ijk, done, torch.zeros_like(done))}
    rows = []
    for cap in caps:
        head = {k: v[:cap] for k, v in st.items()}
        head, row = _grid_round(grid, head, unit=unit, skips=skips,
                                mode=mode, watertight=watertight,
                                filter_mask=filter_mask, steps=steps)
        st = head if cap >= n else {k: torch.cat([head[k], v[cap:]])
                                    for k, v in st.items()}
        rows.append(row)

    # Records in the flat table's slots, then the exactness residual:
    # still-marching and aborted rays re-trace the full tree, their best
    # so far as the window's end.
    best_s = st["best_s"]
    best_s = torch.where(best_s >= 0,
                         grid.cells_to_flat[best_s.clamp_min(0).long()], -1)
    live = st["cell"] != -1
    trace = trace_packets_reference if plain else trace_packets
    hr = trace(grid.flat, Rays(st["o"], st["d"], st["mint"],
                               torch.where(live, st["best_t"], 0.0)),
               mode=mode, watertight=watertight, sort_rays=True,
               filter_mask=filter_mask)
    ri = hr.slot >= 0
    best_t = torch.where(ri, hr.t, st["best_t"])
    best_s = torch.where(ri, hr.slot, best_s)
    idx = st["idx"]
    t = torch.empty_like(best_t)
    slot = torch.empty_like(best_s)
    t[idx] = best_t
    slot[idx] = best_s

    # u, v of each winner from one re-test of its triangle, in the
    # kernel's shear-space arithmetic (rtk_tpu/testing/grid.py:686-698).
    hit = slot >= 0
    tri = grid.flat.tri_v[slot.clamp_min(0).long()]
    _, ru, rv, _ = intersect_triangles(
        o, ray_shear(d), tri[:, None], mint, torch.full_like(mint, _BIG),
        watertight=watertight)
    zero = torch.zeros((), device=dev)
    hits = PacketHits(
        hit=hit, t=t, u_k=torch.where(hit, ru[:, 0], zero),
        v_k=torch.where(hit, rv[:, 0], zero), slot=slot, origin=rays.origin,
        direction=rays.direction, tri_v=grid.flat.tri_v,
        tri_vidx=grid.flat.tri_vidx, tri_mesh=grid.flat.tri_mesh,
        tri_prim=grid.flat.tri_prim)
    if debug_counts:
        cnts = (torch.stack(rows) if rows
                else torch.zeros((1, 3), dtype=torch.int32, device=dev))
        return hits, (cnts, live.sum().to(torch.int32))
    return hits

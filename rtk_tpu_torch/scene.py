"""Scene: the device-resident acceleration structure (a dataclass of tensors).

The LBVH build of rtk_tpu.scene in PyTorch: Morton codes of triangle
centroids, one stable sort, the Karras topology over leaf clusters, a
range-query refit of the bounds and the wide collapse.  Every output is
bit-equal to rtk_tpu's on the same input.  Triangles are stored in
traversal (Morton-sorted) order so every leaf is a contiguous slice.
`refit` moves a built Scene to deformed vertices with the topology kept,
on the scene's device, nothing on the host: on the card in the port's
own launches (`refit_kernel`, csrc/refit.cu), elsewhere by eager
gathers, minima and maxima (`refit_reference`, its plain version).  The
choice is ops/packet_trace.py's `front_steps` by device, as for every
step of the front end.  Its body is the span `rtk.refit`
(utils/stats.py::span) and REFITS counts its calls.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from rtk_tpu_torch.builder.collapse import collapse_wide, gather_slot_bounds
from rtk_tpu_torch.builder.lbvh import (karras_topology_scan, leaf_code,
                                        refit_ranges_flat)
from rtk_tpu_torch.config import BuildConfig
from rtk_tpu_torch.ops import library
from rtk_tpu_torch.ops.morton import morton3d
from rtk_tpu_torch.utils.stats import span

# Refits in this process (refit, and trace/packed.py's refit_packed_binary):
# a run resets them and reads them back, as ops/packet_trace.py's launch
# counters.  REFIT_LAUNCHES counts the card refit's launches
# (refit_kernel): 2 a refit, 3 where the Scene has wide node arrays.
REFITS = 0
REFIT_LAUNCHES = 0


@dataclasses.dataclass
class Scene:
    """Built acceleration structure + geometry, all tensors on one device."""

    # Wide BVH (SoA). Row 0 is the root. Child encoding: >=0 wide node id,
    # -1 empty, <=-2 leaf id -(c)-2.  Slot values are *binary* node ids
    # (rows are binary-indexed, see builder/collapse.py).
    node_child: torch.Tensor  # (Nn, W) i32
    node_min: torch.Tensor  # (Nn, W, 3) f32
    node_max: torch.Tensor  # (Nn, W, 3) f32
    # Binary topology + bounds (the packed kernel tables derive from these).
    bin_left: torch.Tensor  # (Li,) i32
    bin_right: torch.Tensor  # (Li,) i32
    bin_lo: torch.Tensor  # (Li,) i32 first leaf of the node's range
    bin_hi: torch.Tensor  # (Li,) i32 last leaf
    bin_min: torch.Tensor  # (Li, 3) f32
    bin_max: torch.Tensor  # (Li, 3) f32
    leaf_min: torch.Tensor  # (L, 3) f32
    leaf_max: torch.Tensor  # (L, 3) f32
    # Triangles in traversal (Morton-sorted) order, padded to L*leaf_size.
    tri_v: torch.Tensor  # (Tp, 3, 3) f32
    tri_vidx: torch.Tensor  # (Tp, 3) i32 original vertex indices
    tri_mesh: torch.Tensor  # (Tp,) i32
    tri_prim: torch.Tensor  # (Tp,) i32
    perm: torch.Tensor  # (Tp,) i32 sorted slot -> original soup index (-1 pad)
    bounds_min: torch.Tensor  # (3,) f32
    bounds_max: torch.Tensor  # (3,) f32
    num_tris: int
    leaf_size: int
    branching: int
    num_leaves: int
    # BuildConfig(wide_nodes=False) skips the wide collapse; node_child/
    # node_min/node_max are then 1-row dummies.
    has_wide: bool = True

    @property
    def num_padded_tris(self) -> int:
        return self.tri_v.shape[0]

    @property
    def device(self) -> torch.device:
        return self.tri_v.device


def centroid_codes(tri_pos: torch.Tensor, morton_bits: int = 10):
    """(codes, lo, hi): Morton codes of the triangle centroids inside the
    scene bounds, evaluated exactly as rtk_tpu's build does
    ((a + b + c) * f32(1/3), then quantise), so the codes are bit-equal."""
    lo = tri_pos.amin(dim=(0, 1))
    hi = tri_pos.amax(dim=(0, 1))
    third = torch.tensor(1.0 / 3.0, dtype=torch.float32, device=tri_pos.device)
    cc = (tri_pos[:, 0] + tri_pos[:, 1] + tri_pos[:, 2]) * third
    return morton3d(cc, lo, hi, bits=morton_bits), lo, hi


def _build_impl(tri_pos, tri_vidx, tri_mesh, tri_prim, codes=None, *,
                leaf_size, branching, morton_bits, wide=True):
    dev = tri_pos.device
    t = tri_pos.shape[0]
    n_leaf = max(1, -(-t // leaf_size))
    tp = n_leaf * leaf_size
    i32 = dict(dtype=torch.int32, device=dev)

    if codes is None:
        codes, lo, hi = centroid_codes(tri_pos, morton_bits)
    else:
        lo = tri_pos.amin(dim=(0, 1))
        hi = tri_pos.amax(dim=(0, 1))
    # Lexicographic (code, index) order == a stable sort on the code.
    sort_codes, perm = torch.sort(codes, stable=True)

    pad = tp - t
    sort_v = torch.cat([tri_pos[perm],
                        torch.zeros((pad, 3, 3), dtype=torch.float32,
                                    device=dev)])
    perm_p = torch.cat([perm.to(torch.int32), torch.full((pad,), -1, **i32)])
    valid = perm_p >= 0
    if tri_vidx is None and tri_mesh is None and tri_prim is None:
        # Default metadata is a pure function of the permutation.
        sort_prim = torch.where(valid, perm_p, -1)
        sort_mesh = torch.where(valid, 0, -1).to(torch.int32)
        sort_vidx = torch.stack([torch.where(valid, perm_p * 3 + j, -1)
                                 for j in range(3)], dim=1)
    else:
        if tri_vidx is None:
            tri_vidx = (torch.arange(t, **i32)[:, None] * 3
                        + torch.arange(3, **i32)[None, :])
        if tri_mesh is None:
            tri_mesh = torch.zeros((t,), **i32)
        if tri_prim is None:
            tri_prim = torch.arange(t, **i32)
        sort_vidx = torch.cat([tri_vidx[perm], torch.full((pad, 3), -1, **i32)])
        sort_mesh = torch.cat([tri_mesh[perm], torch.full((pad,), -1, **i32)])
        sort_prim = torch.cat([tri_prim[perm], torch.full((pad,), -1, **i32)])

    # Per-leaf AABBs over (L, K) chunks of the sorted triangles.
    vmin = torch.where(valid[:, None], sort_v.amin(dim=1), float("inf"))
    vmax = torch.where(valid[:, None], sort_v.amax(dim=1), -float("inf"))
    leaf_min = vmin.reshape(n_leaf, leaf_size, 3).amin(dim=1)
    leaf_max = vmax.reshape(n_leaf, leaf_size, 3).amax(dim=1)

    w = branching
    if n_leaf == 1:
        # Degenerate scene: a single wide root with one leaf child.
        node_child = torch.full((1, w), -1, **i32)
        node_child[0, 0] = leaf_code(0)
        node_min = torch.full((1, w, 3), 1.0, device=dev)
        node_max = torch.full((1, w, 3), -1.0, device=dev)
        node_min[0, 0] = leaf_min[0]
        node_max[0, 0] = leaf_max[0]
        bin_left = torch.full((1,), leaf_code(0), **i32)
        bin_right = torch.full((1,), -1, **i32)  # empty slot
        bin_lo = torch.zeros((1,), **i32)
        bin_hi = torch.zeros((1,), **i32)
        bmin, bmax = leaf_min, leaf_max
    else:
        cluster_codes = sort_codes[::leaf_size]
        bin_left, bin_right, bin_lo, bin_hi = karras_topology_scan(
            cluster_codes)
        bmin, bmax = refit_ranges_flat(bin_lo, bin_hi, leaf_min, leaf_max)
        if wide:
            node_child, node_min, node_max = collapse_wide(
                bin_left, bin_right, bmin, bmax, leaf_min, leaf_max, w)
        else:
            node_child = torch.full((1, w), -1, **i32)
            node_min = torch.full((1, w, 3), 1.0, device=dev)
            node_max = torch.full((1, w, 3), -1.0, device=dev)

    return dict(
        node_child=node_child, node_min=node_min, node_max=node_max,
        bin_left=bin_left, bin_right=bin_right, bin_lo=bin_lo, bin_hi=bin_hi,
        bin_min=bmin, bin_max=bmax, leaf_min=leaf_min, leaf_max=leaf_max,
        tri_v=sort_v, tri_vidx=sort_vidx.to(torch.int32),
        tri_mesh=sort_mesh.to(torch.int32), tri_prim=sort_prim.to(torch.int32),
        perm=perm_p, bounds_min=lo, bounds_max=hi)


def build_from_soup(tri_pos, tri_vidx=None, tri_mesh=None, tri_prim=None,
                    config: BuildConfig = BuildConfig(), codes=None,
                    device="cuda") -> Scene:
    """Build a Scene from canonical triangle-soup arrays on `device`.

    codes: optional (T,) sort keys in [0, 2^32) replacing the Morton codes
    of the centroids; the topology then follows their prefix hierarchy
    (the macro-grid's cell-major keys, testing/grid.py, use bit 31, so
    custom keys are held in int64; the default Morton codes are int32)."""
    def cvt(a, dt):
        if a is None:
            return None
        if not isinstance(a, torch.Tensor):
            a = np.asarray(a)
        return torch.as_tensor(a, device=device).to(dt)

    tri_pos = cvt(tri_pos, torch.float32).reshape(-1, 3, 3)
    t = tri_pos.shape[0]
    if t == 0:
        raise ValueError("cannot build an empty scene")
    if codes is not None:
        if not isinstance(codes, torch.Tensor):
            codes = np.asarray(codes).astype(np.int64)  # uint32 keys too
        codes = cvt(codes, torch.int64).reshape(-1)
        if codes.shape[0] != t:
            raise ValueError(f"{codes.shape[0]} codes for {t} triangles")
        if t and (int(codes.min()) < 0 or int(codes.max()) >= 1 << 32):
            raise ValueError("codes must lie in [0, 2^32)")
    arrays = _build_impl(
        tri_pos, cvt(tri_vidx, torch.int32), cvt(tri_mesh, torch.int32),
        cvt(tri_prim, torch.int32), codes, leaf_size=config.leaf_size,
        branching=config.branching, morton_bits=config.morton_bits,
        wide=config.wide_nodes)
    n_leaf = max(1, -(-t // config.leaf_size))
    return Scene(num_tris=t, leaf_size=config.leaf_size,
                 branching=config.branching, num_leaves=n_leaf,
                 has_wide=config.wide_nodes or n_leaf == 1, **arrays)


def soup_tensor(tri_pos, num_tris: int, device) -> torch.Tensor:
    """A frame's (T, 3, 3) soup, array or tensor, as float32 on `device`;
    raises unless it holds num_tris triangles."""
    if not isinstance(tri_pos, torch.Tensor):
        tri_pos = torch.from_numpy(
            np.ascontiguousarray(tri_pos, dtype=np.float32))
    tri_pos = tri_pos.to(device=device, dtype=torch.float32).reshape(-1, 3, 3)
    if tri_pos.shape[0] != num_tris:
        raise ValueError(f"{tri_pos.shape[0]} triangles for a topology of "
                         f"{num_tris}")
    return tri_pos


def _leaf_bounds(tri_v: torch.Tensor, num_tris: int, leaf_size: int):
    """Masked per-leaf AABBs over chunks of sorted triangles: a sorted row
    is real by position (row < num_tris); padding rows enter the minimum
    as +inf and the maximum as -inf."""
    tp = tri_v.shape[0]
    n_leaf = tp // leaf_size
    valid = (torch.arange(tp, device=tri_v.device) < num_tris)[:, None, None]
    lo = torch.where(valid, tri_v, float("inf"))
    hi = torch.where(valid, tri_v, -float("inf"))
    return (lo.reshape(n_leaf, leaf_size * 3, 3).amin(dim=1),
            hi.reshape(n_leaf, leaf_size * 3, 3).amax(dim=1))


def _one_leaf_slots(scene: Scene, leaf_min, leaf_max):
    """The one-leaf scene's wide row refit: slot 0 of row 0 is the leaf,
    the other slots stay empty as built."""
    node_min, node_max = scene.node_min.clone(), scene.node_max.clone()
    node_min[0, 0] = leaf_min[0]
    node_max[0, 0] = leaf_max[0]
    return node_min, node_max


def _refit_impl(scene: Scene, new_tri_pos: torch.Tensor) -> dict:
    """Regather the vertices in sorted order and refit every bound, the
    topology kept (rtk has no refit: it rebuilds)."""
    perm = scene.perm
    # Padding rows of perm hold -1: gather through a clamp, then zero them.
    gathered = new_tri_pos[perm.clamp(0, scene.num_tris - 1).long()]
    sort_v = torch.where((perm >= 0)[:, None, None], gathered, 0.0)
    leaf_min, leaf_max = _leaf_bounds(sort_v, scene.num_tris,
                                      scene.leaf_size)
    node_min, node_max = scene.node_min, scene.node_max
    if leaf_min.shape[0] == 1:
        node_min, node_max = _one_leaf_slots(scene, leaf_min, leaf_max)
        bmin, bmax = leaf_min, leaf_max
    else:
        bmin, bmax = refit_ranges_flat(scene.bin_lo, scene.bin_hi, leaf_min,
                                       leaf_max)
        if scene.has_wide:  # else 1-row dummies, left as they are
            node_min, node_max = gather_slot_bounds(
                scene.node_child, bmin, bmax, leaf_min, leaf_max)
    return dict(node_min=node_min, node_max=node_max, tri_v=sort_v,
                bounds_min=leaf_min.amin(dim=0),
                bounds_max=leaf_max.amax(dim=0), bin_min=bmin, bin_max=bmax,
                leaf_min=leaf_min, leaf_max=leaf_max)


def refit_reference(scene: Scene, tri_pos: torch.Tensor) -> Scene:
    """refit_kernel's plain version on any device (the plain steps'
    refit): tri_pos, the frame as soup_tensor gives it, gathered in the
    sorted order, the leaf bounds reduced and the node bounds answered from
    a range table (builder/lbvh.py::refit_ranges_flat), eager op by op."""
    return dataclasses.replace(scene, **_refit_impl(scene, tri_pos))


def refit_kernel(scene: Scene, tri_pos: torch.Tensor, lib=None) -> Scene:
    """refit on the card: csrc/refit.cu's rtk_refit_parents and
    rtk_refit_leaves (rtk_refit_parents skipped for the one-leaf scene),
    and rtk_refit_slots where the Scene has wide node arrays, on the
    current stream, with no host sync; every output a new tensor
    (torch.empty), equal bit for bit to refit_reference of the same frame
    on the CPU but for the sign of a zero bound where the range table pairs
    a -0.0 with a +0.0 (csrc/refit.cu says which).  The one-leaf scene's
    slot bounds are written as refit_reference writes them.

    tri_pos: (num_tris, 3, 3) float32 on the scene's card, as soup_tensor
    gives it.  lib: a loaded library to launch from (an AOT artifact's,
    utils/aot.py) instead of the one built from the sources.  Raises if the
    tensors are not on one card or their shapes are not the scene's."""
    global REFIT_LAUNCHES
    dev = scene.device
    if dev.type != "cuda":
        raise ValueError("refit_kernel takes a Scene on a CUDA device; the "
                         "plain version is refit_reference")
    n_leaf, k = scene.num_leaves, scene.leaf_size
    n_int = n_leaf - 1
    i32, check = torch.int32, library.check_tensor
    check(tri_pos, "tri_pos", torch.float32, (scene.num_tris, 3, 3), dev)
    check(scene.perm, "scene.perm", i32, (n_leaf * k,), dev)
    for name in ("bin_left", "bin_right"):
        check(getattr(scene, name), f"scene.{name}", i32, (max(n_int, 1),),
              dev)
    if lib is None:
        lib = library.load_kernel()
    f32 = dict(dtype=torch.float32, device=dev)
    tri_pos = tri_pos.contiguous()
    left, right = scene.bin_left.contiguous(), scene.bin_right.contiguous()
    tri_v = torch.empty((n_leaf * k, 3, 3), **f32)
    leaf_min, leaf_max = (torch.empty((n_leaf, 3), **f32) for _ in range(2))
    bounds_min, bounds_max = (torch.empty((3,), **f32) for _ in range(2))
    if n_int:
        bmin, bmax = (torch.empty((n_int, 3), **f32) for _ in range(2))
    else:
        bmin, bmax = leaf_min, leaf_max  # as refit_reference returns them
    # Each internal node's parent, each leaf's, each node's arrival count.
    scratch = torch.empty((2 * n_int + n_leaf,), dtype=i32, device=dev)
    if n_int:
        library.launch(dev, "rtk_refit_parents", lib.rtk_refit_parents,
                       left.data_ptr(), right.data_ptr(), n_int, n_leaf,
                       scratch.data_ptr())
        REFIT_LAUNCHES += 1
    library.launch(dev, "rtk_refit_leaves", lib.rtk_refit_leaves,
                   tri_pos.data_ptr(), scene.num_tris,
                   scene.perm.contiguous().data_ptr(), n_leaf, k,
                   left.data_ptr(), right.data_ptr(), scratch.data_ptr(),
                   tri_v.data_ptr(), leaf_min.data_ptr(), leaf_max.data_ptr(),
                   bmin.data_ptr(), bmax.data_ptr(), bounds_min.data_ptr(),
                   bounds_max.data_ptr())
    REFIT_LAUNCHES += 1
    node_min, node_max = scene.node_min, scene.node_max
    if not n_int:
        node_min, node_max = _one_leaf_slots(scene, leaf_min, leaf_max)
    elif scene.has_wide:  # else 1-row dummies, left as they are
        child = scene.node_child.contiguous()
        check(child, "scene.node_child", i32, tuple(node_min.shape[:2]), dev)
        node_min, node_max = (torch.empty(tuple(node_min.shape), **f32)
                              for _ in range(2))
        library.launch(dev, "rtk_refit_slots", lib.rtk_refit_slots,
                       child.data_ptr(), child.numel(), n_int, n_leaf,
                       bmin.data_ptr(), bmax.data_ptr(), leaf_min.data_ptr(),
                       leaf_max.data_ptr(), node_min.data_ptr(),
                       node_max.data_ptr())
        REFIT_LAUNCHES += 1
    return dataclasses.replace(
        scene, node_min=node_min, node_max=node_max, tri_v=tri_v,
        bounds_min=bounds_min, bounds_max=bounds_max, bin_min=bmin,
        bin_max=bmax, leaf_min=leaf_min, leaf_max=leaf_max)


def refit_by(step, scene: Scene, new_tri_pos) -> Scene:
    """refit through `step` (a Steps' refit, ops/packet_trace.py: an AOT
    artifact passes its own library's): the frame put on the scene's device
    by soup_tensor, the call counted in REFITS, its body the span
    `rtk.refit`."""
    global REFITS
    REFITS += 1
    with span("rtk.refit"):
        return step(scene, soup_tensor(new_tri_pos, scene.num_tris,
                                       scene.device))


def refit(scene: Scene, new_tri_pos) -> Scene:
    """Refit an existing Scene to deformed geometry (same topology).

    new_tri_pos: (T, 3, 3) triangle vertices in the *original soup order*
    (the order passed to build_from_soup), an array or a tensor; the work
    runs on the scene's device and is only enqueued there: refit_kernel
    on a card, refit_reference on the CPU.
    """
    from rtk_tpu_torch.ops.packet_trace import front_steps  # imports us

    return refit_by(front_steps(scene.device).refit, scene, new_tri_pos)

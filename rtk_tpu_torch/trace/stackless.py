"""Stackless skip-link traversal (rtk_tpu.trace.stackless) in plain
PyTorch on the scene's device.

The binary LBVH is linearised in DFS preorder into one entity table.  An
entity is either an internal node (its box and a skip link) or an inline
triangle (its vertices and hit slot).  Each ray walks the table with one
int of state:

    hit internal node  -> next = cur + 1   (the first child is adjacent)
    missed internal    -> next = skip      (jump over the subtree)
    triangle           -> test, next = cur + 1
    cur == E           -> done

rtk's stack traversal (rtk.c:519-536) turned inside out: the preorder and
the skip links encode the control flow in data.  t-culling still happens
at every box test against the running closest hit.

rtk_tpu computes this with plain XLA (fixpoint sweeps for the preorder, a
while_loop for the trace), with no kernel of its own, so it is plain
PyTorch here too.  The entity table is bit-equal to rtk_tpu's on the same
Scene.
"""
from __future__ import annotations

import dataclasses

import torch

from rtk_tpu_torch.ops.intersect import _edge_f64, ray_shear
from rtk_tpu_torch.ops.packet_trace import _crcp
from rtk_tpu_torch.scene import Scene
from rtk_tpu_torch.types import Hits, Rays

# Entity rows of 16 int32: internal [min (3) max (3) skip kind 0 ...];
# triangle [v0 v1 v2 (9) slot kind 0 ...] (f32 payloads bitcast).
ROW_I32 = 16
KIND_COL = 10
SKIP_COL = 6
SLOT_COL = 9
# Steps between the trace loop's checks for rays still walking.  Each
# check reads a count back (a host sync) and compacts the live rays; a
# finished ray's state no longer changes, so the steps past its end
# change no record.
CHECK_EVERY = 32


@dataclasses.dataclass
class StacklessScene:
    entities: torch.Tensor  # (E, 16) i32 rows (f32 payloads bitcast)
    # Hit assembly uses the Scene's sorted triangle arrays (slot indexes
    # them).
    tri_v: torch.Tensor
    tri_vidx: torch.Tensor
    tri_mesh: torch.Tensor
    tri_prim: torch.Tensor
    num_tris: int

    @property
    def num_entities(self) -> int:
        return self.entities.shape[0]

    @property
    def device(self) -> torch.device:
        return self.entities.device


def _bits(a):
    return a.to(torch.float32).contiguous().view(torch.int32)


def _tri_rows(tri_v):
    """Triangle entities: [v0 v1 v2 (bitcast), slot, kind 1, 0...]."""
    tp = tri_v.shape[0]
    dev = tri_v.device
    return torch.cat([
        _bits(tri_v.reshape(tp, 9)),
        torch.arange(tp, dtype=torch.int32, device=dev)[:, None],
        torch.ones((tp, 1), dtype=torch.int32, device=dev),
        torch.zeros((tp, ROW_I32 - 11), dtype=torch.int32, device=dev)], 1)


def _set_drop(dst, index, values):
    """dst.at[index].set(values, mode="drop") for indices in [0, len(dst)]:
    writes at len(dst) fall off the end."""
    ext = torch.cat([dst, dst.new_zeros((1,) + dst.shape[1:])])
    ext[index] = values
    return ext[:-1]


def _linearise(bin_left, bin_right, bin_min, bin_max, tri_v, n_leaf: int,
               leaf_size: int):
    """DFS-preorder entity table from the binary topology, by the
    reference's fixpoint sweeps (rtk_tpu/trace/stackless.py:62-163): the
    subtree sizes bottom up, the preorder positions top down; one host
    sync a sweep."""
    n_int = bin_left.shape[0]
    k = leaf_size
    dev = bin_left.device
    left, right = bin_left.long(), bin_right.long()

    def child_size(child, sizes):
        return (torch.where(child <= -2, k, sizes[child.clamp(0, n_int - 1)]),
                child >= 0)

    # Subtree sizes in entities, bottom up: sweeps == height.
    sizes = torch.zeros((n_int,), dtype=torch.int32, device=dev)
    valid = torch.zeros((n_int,), dtype=torch.bool, device=dev)
    while not bool(valid[0]):
        ls, l_int = child_size(left, sizes)
        rs, r_int = child_size(right, sizes)
        lv = torch.where(l_int, valid[left.clamp(0, n_int - 1)], True)
        rv = torch.where(r_int, valid[right.clamp(0, n_int - 1)], True)
        ok = lv & rv
        new = 1 + ls + torch.where(right == -1, 0, rs)
        sizes = torch.where(ok, new, sizes).to(torch.int32)
        valid = valid | ok

    # Preorder index, top down: idx(left) = idx + 1, idx(right) = idx + 1
    # + size(left).
    lsz, _ = child_size(left, sizes)
    li = torch.where(left >= 0, left, n_int)
    ri = torch.where(right >= 0, right, n_int)
    idx = torch.zeros((n_int,), dtype=torch.int32, device=dev)
    valid = torch.zeros((n_int,), dtype=torch.bool, device=dev)
    valid[0] = True
    while not bool(valid.all()):
        src_ok = valid
        idx = _set_drop(idx, li, torch.where(src_ok, idx + 1, 0))
        idx = _set_drop(idx, ri, torch.where(src_ok, idx + 1 + lsz, 0))
        valid = _set_drop(valid, li, src_ok) | valid
        valid = _set_drop(valid, ri, src_ok) | valid

    zeros = torch.zeros((n_int, 1), dtype=torch.int32, device=dev)
    int_rows = torch.cat([_bits(bin_min), _bits(bin_max),
                          (idx + sizes)[:, None], zeros,
                          zeros.expand(n_int, ROW_I32 - 8)], 1)

    # A leaf's triangles sit at its preorder position, from the parent
    # that names it.
    leaf_idx = torch.zeros((n_leaf,), dtype=torch.int32, device=dev)
    for child, pos in ((left, idx + 1), (right, idx + 1 + lsz)):
        is_leaf = child <= -2
        lid = torch.where(is_leaf, -child - 2, n_leaf)
        leaf_idx = _set_drop(leaf_idx, lid, torch.where(is_leaf, pos, 0))

    entities = torch.zeros((n_leaf * k + n_int, ROW_I32), dtype=torch.int32,
                           device=dev)
    entities[idx.long()] = int_rows
    tri_pos = (leaf_idx[:, None]
               + torch.arange(k, dtype=torch.int32, device=dev)).reshape(-1)
    entities[tri_pos.long()] = _tri_rows(tri_v)
    return entities


def build_stackless(scene: Scene) -> StacklessScene:
    """Linearise a built Scene for stackless traversal, on its device."""
    if scene.num_leaves == 1:
        # One leaf, no internal node: a root box entity above it.
        k = scene.leaf_size
        dev = scene.device
        root = torch.cat([
            _bits(scene.bounds_min), _bits(scene.bounds_max),
            torch.tensor([1 + k, 0], dtype=torch.int32, device=dev),
            torch.zeros((ROW_I32 - 8,), dtype=torch.int32, device=dev)])
        entities = torch.cat([root[None], _tri_rows(scene.tri_v)])
    else:
        entities = _linearise(scene.bin_left, scene.bin_right, scene.bin_min,
                              scene.bin_max, scene.tri_v, scene.num_leaves,
                              scene.leaf_size)
    return StacklessScene(entities=entities, tri_v=scene.tri_v,
                          tri_vidx=scene.tri_vidx, tri_mesh=scene.tri_mesh,
                          tri_prim=scene.tri_prim, num_tris=scene.num_tris)


def _walk(ent, ent_f, w, mode, watertight):
    """One step of every ray in the working set `w` (dict of tensors),
    in place (rtk_tpu/trace/stackless.py:221-274)."""
    e_count = ent.shape[0]
    cur = w["cur"]
    o, rcp, mint, hit_t = w["o"], w["rcp"], w["mint"], w["t"]
    safe = cur.clamp(0, e_count - 1)
    rows = ent[safe]
    fr = ent_f[safe, :9]
    done = cur >= e_count
    is_tri = (rows[:, KIND_COL] == 1) & ~done
    is_node = (rows[:, KIND_COL] == 0) & ~done

    # Internal: one slab test, planes picked by the direction's sign.
    pos = rcp >= 0
    lo, hi = fr[:, 0:3], fr[:, 3:6]
    near = (torch.where(pos, lo, hi) - o) * rcp
    far = (torch.where(pos, hi, lo) - o) * rcp
    enter = torch.maximum(torch.maximum(near[:, 0], near[:, 1]),
                          torch.maximum(near[:, 2], mint))
    exit_ = torch.minimum(torch.minimum(far[:, 0], far[:, 1]),
                          torch.minimum(far[:, 2], hit_t))
    box_hit = enter <= exit_

    # Triangle: the watertight shear-space test.  The exact-zero edge
    # fix-up is a select, not a branch (a branch would read a flag back).
    xs, ys, zs = [], [], []
    for j in range(3):
        v = fr[:, 3 * j:3 * j + 3] - o
        px, py, pz = (v.gather(1, w[a]).squeeze(1) for a in ("kx", "ky", "kz"))
        xs.append(px + w["sx"] * pz)
        ys.append(py + w["sy"] * pz)
        zs.append(w["sz"] * pz)
    u = xs[1] * ys[2] - ys[1] * xs[2]
    v_ = xs[2] * ys[0] - ys[2] * xs[0]
    w_ = xs[0] * ys[1] - ys[0] * xs[1]
    if watertight:
        need = (u == 0.0) | (v_ == 0.0) | (w_ == 0.0)
        u = torch.where(need, _edge_f64(xs[1], ys[1], xs[2], ys[2]), u)
        v_ = torch.where(need, _edge_f64(xs[2], ys[2], xs[0], ys[0]), v_)
        w_ = torch.where(need, _edge_f64(xs[0], ys[0], xs[1], ys[1]), w_)
    lo_uvw = torch.minimum(torch.minimum(u, v_), w_)
    hi_uvw = torch.maximum(torch.maximum(u, v_), w_)
    rcp_det = 1.0 / (u + v_ + w_)
    t = (u * zs[0] + v_ * zs[1] + w_ * zs[2]) * rcp_det
    ok = (is_tri & ~((lo_uvw < 0.0) & (hi_uvw > 0.0)) & (t > mint)
          & (t < hit_t))
    w["t"] = torch.where(ok, t, hit_t)
    w["u"] = torch.where(ok, u * rcp_det, w["u"])
    w["v"] = torch.where(ok, v_ * rcp_det, w["v"])
    w["slot"] = torch.where(ok, rows[:, SLOT_COL], w["slot"])

    nxt = torch.where(is_node,
                      torch.where(box_hit, cur + 1, rows[:, SKIP_COL].long()),
                      cur + 1)
    if mode == "any":
        nxt = torch.where(ok, e_count, nxt)  # the first hit ends the ray
    w["cur"] = torch.where(done, cur, nxt)


def _trace_impl(ent, o, d, mint, maxt, mode, watertight):
    """Walk every ray to the end of the table -> (t, u, v, slot).  The
    rays still walking are checked (and compacted) every CHECK_EVERY
    steps."""
    n = o.shape[0]
    dev = o.device
    e_count = ent.shape[0]
    sh = ray_shear(d)
    out = {"t": maxt.clone(),
           "u": torch.zeros((n,), dtype=torch.float32, device=dev),
           "v": torch.zeros((n,), dtype=torch.float32, device=dev),
           "slot": torch.full((n,), -1, dtype=torch.int32, device=dev)}
    w = {"ids": torch.arange(n, device=dev), "o": o, "rcp": _crcp(d),
         "mint": mint, "kx": sh.kx[:, None], "ky": sh.ky[:, None],
         "kz": sh.kz[:, None], "sx": sh.sx, "sy": sh.sy, "sz": sh.sz,
         "cur": torch.zeros((n,), dtype=torch.int64, device=dev),
         **{k: v.clone() for k, v in out.items()}}
    ent_f = ent.view(torch.float32)
    steps = 0
    while w["ids"].numel():
        _walk(ent, ent_f, w, mode, watertight)
        steps += 1
        if steps % CHECK_EVERY:
            continue
        fin = w["cur"] >= e_count
        f = torch.nonzero(fin).squeeze(1)
        ids = w["ids"][f]
        for k in out:
            out[k][ids] = w[k][f]
        keep = torch.nonzero(~fin).squeeze(1)
        w = {k: v[keep] for k, v in w.items()}
    return out["t"], out["u"], out["v"], out["slot"]


def trace_stackless(sl: StacklessScene, rays: Rays, mode: str = "closest",
                    watertight: bool = True, sort_rays: bool = False) -> Hits:
    """Trace rays with the stackless engine on the scene's device -> Hits.
    sort_rays: walk the rays in the render path's coherence order
    (models/path.py::_ray_sort_key); records come back in the caller's
    order."""
    if mode not in ("closest", "any"):
        raise ValueError(f"unknown mode {mode!r}")
    if rays.device != sl.device:
        raise ValueError(f"rays on {rays.device}, scene on {sl.device}")
    o = rays.origin.to(torch.float32)
    d = rays.direction.to(torch.float32)
    mn = rays.min_t.to(torch.float32)
    mx = rays.max_t.to(torch.float32)
    perm = None
    if sort_rays:
        from rtk_tpu_torch.models.path import _ray_sort_key

        pts = sl.tri_v.reshape(-1, 3)
        key = _ray_sort_key(rays, pts.amin(dim=0), pts.amax(dim=0))
        perm = torch.sort(key, stable=True).indices
        o, d, mn, mx = o[perm], d[perm], mn[perm], mx[perm]
    out = _trace_impl(sl.entities, o, d, mn, mx, mode, watertight)
    if perm is not None:
        def unsort(a):
            b = torch.empty_like(a)
            b[perm] = a
            return b

        out = tuple(map(unsort, out))
    t, u, v, slot = out
    hit = slot >= 0
    safe = slot.clamp(0, sl.tri_v.shape[0] - 1).long()
    zero = torch.zeros((), device=t.device)
    return Hits(
        hit=hit, t=t, u=torch.where(hit, u, zero),
        v=torch.where(hit, v, zero),
        mesh_index=torch.where(hit, sl.tri_mesh[safe], -1),
        triangle_index=torch.where(hit, sl.tri_prim[safe], -1),
        vertex_position=torch.where(hit[:, None, None], sl.tri_v[safe], zero),
        vertex_index=torch.where(hit[:, None], sl.tri_vidx[safe], -1))

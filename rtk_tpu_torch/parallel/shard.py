"""Ray, scene and hybrid sharding over a mesh of torch devices.

rtk_tpu.parallel.shard's three modes.  The reference is single-controller
(one process runs jax.shard_map over a Mesh of devices), and so is this
module: one process enqueues every shard's work on its own device.

  * Ray sharding (trace_sharded, trace_packets_sharded,
    trace_grid_sharded, trace_instanced_sharded): the scene is copied to
    each distinct device of the mesh once per call, the ray batch splits
    into one contiguous shard per mesh entry, and every shard traces on its
    device with no exchange.  The results come back to the rays' device in
    the caller's order.
  * Scene sharding (build_scene_sharded + trace_*_scene_sharded): the
    triangle soup splits by a recursive median split into one sub-scene
    per entry of the mesh's first axis.  Every part traces every ray, and
    one plain function over the stacked per-part results on the rays'
    device picks each ray's record (the reference's pmin, rank tie-break
    and psum over the scene axis).
  * Hybrid (hybrid_mesh): a 2-D ("scene", "rays") mesh.  The scene splits
    over the rows and the ray batch over the columns; the combine runs
    over the rows only.

A Mesh is a numpy grid of torch.device entries, and entries may repeat.
On one card, a mesh whose entries all name that card runs every shard's
launches and the combine on it, as the reference's tests run every mode on
8 virtual CPU devices; a mesh of torch.device("cpu") entries runs the
kernel's plain version.  Times on such a mesh measure what splitting
costs, not how it scales.

The packet front ends make no host sync, so on a mesh of several cards
the shards overlap; the stack engine (trace_sharded) syncs every step.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from rtk_tpu_torch import instancing as _inst
from rtk_tpu_torch.config import BuildConfig, TraceConfig
from rtk_tpu_torch.mesh import TriangleSoup, build_soup
from rtk_tpu_torch.ops.packet_trace import DEFAULT_P, trace_packets
from rtk_tpu_torch.scene import Scene, build_from_soup
from rtk_tpu_torch.testing.grid import trace_packets_grid
from rtk_tpu_torch.trace import stack as _stack
from rtk_tpu_torch.trace.packed import PackedScene, pack_scene
from rtk_tpu_torch.types import Hits, PacketHits, Rays

__all__ = [
    "Mesh", "default_mesh", "hybrid_mesh", "trace_sharded",
    "trace_closest_sharded", "trace_any_sharded", "trace_packets_sharded",
    "trace_grid_sharded", "trace_instanced_sharded", "ShardedScene",
    "partition_soup", "build_scene_sharded", "trace_scene_sharded",
    "trace_closest_scene_sharded", "trace_any_scene_sharded",
]


@dataclasses.dataclass(eq=False)
class Mesh:
    """A grid of torch devices with one name per axis: the devices,
    axis_names and shape of a jax.sharding.Mesh.  `devices` may be any
    nested sequence of torch.device (or device strings); it is kept as a
    numpy object array."""

    devices: np.ndarray
    axis_names: tuple = ("rays",)

    def __post_init__(self):
        self.devices = np.asarray(np.frompyfunc(torch.device, 1, 1)(
            np.asarray(self.devices, dtype=object)), dtype=object)
        self.axis_names = tuple(self.axis_names)
        if self.devices.ndim != len(self.axis_names) or not self.devices.size:
            raise ValueError(f"a mesh of shape {self.devices.shape} needs "
                             f"one name per axis, not {self.axis_names}")

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return self.devices.size


def _visible_cards() -> list:
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise RuntimeError(
            "no CUDA device is visible; pass the mesh's devices (for "
            "example [torch.device('cpu')] * 8)")
    return [torch.device("cuda", i) for i in range(n)]


def default_mesh(devices=None, axis_name: str = "rays") -> Mesh:
    """A 1-D mesh over `devices` (default: every visible CUDA device;
    raises if there is none)."""
    devices = _visible_cards() if devices is None else list(devices)
    return Mesh(devices, (axis_name,))


def hybrid_mesh(n_scene: int, devices=None) -> Mesh:
    """2-D ("scene", "rays") mesh: scene parts x ray shards.

    The device list (default: every visible CUDA device) folds into an
    (n_scene, n_dev // n_scene) grid; pass the result to
    build_scene_sharded / trace_*_scene_sharded to split BOTH the scene
    (axis 0) and the ray batch (axis 1).
    """
    devices = np.asarray(_visible_cards() if devices is None else devices,
                         dtype=object).reshape(-1)
    if devices.size % n_scene != 0:
        raise ValueError(
            f"hybrid_mesh: {devices.size} devices do not fold into "
            f"{n_scene} scene rows")
    return Mesh(devices.reshape(n_scene, -1), ("scene", "rays"))


def _on(obj, dev):
    """obj (a tensor, or a dataclass of tensors and nested dataclasses)
    on `dev`; tensors there already are shared, not copied."""
    if isinstance(obj, torch.Tensor):
        return obj.to(dev)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: _on(getattr(obj, f.name), dev)
            for f in dataclasses.fields(obj) if f.init})
    return obj


def _spans(n: int, k: int) -> list:
    """[start, end) of each of k contiguous shards of n rays, cut as
    torch.tensor_split cuts them (the first n % k one ray longer).  The
    reference pads the batch to a multiple of k because shard_map needs
    equal shards (_pad_rays); uneven shards trace the same rays, so the
    result is the same and no padding is made."""
    q, r = divmod(n, k)
    cuts = [i * q + min(i, r) for i in range(k + 1)]
    return list(zip(cuts[:-1], cuts[1:]))


def _cat(parts, dev) -> torch.Tensor:
    return torch.cat([p.to(dev) for p in parts])


def _ray_shards(obj, rays: Rays, mesh: Optional[Mesh], trace) -> list:
    """trace(obj's copy on the shard's device, the shard's rays there, the
    shard's first ray index) for each mesh entry, enqueued in turn -> the
    outputs in shard order."""
    devs = list((default_mesh() if mesh is None else mesh).devices.ravel())
    copies = {d: _on(obj, d) for d in set(devs)}
    return [trace(copies[d], _on(rays[s:e], d), s)
            for d, (s, e) in zip(devs, _spans(rays.count, len(devs)))]


def _packet_hits(parts, rays: Rays, tables) -> PacketHits:
    """Per-shard PacketHits -> one PacketHits over `tables`' hit-assembly
    tables, on the rays' device in the caller's order."""
    dev = rays.device
    return PacketHits(
        **{f: _cat([getattr(h, f) for h in parts], dev)
           for f in ("hit", "t", "u_k", "v_k", "slot")},
        origin=rays.origin, direction=rays.direction, tri_v=tables.tri_v,
        tri_vidx=tables.tri_vidx, tri_mesh=tables.tri_mesh,
        tri_prim=tables.tri_prim)


def trace_sharded(
    scene: Scene,
    rays: Rays,
    mesh: Optional[Mesh] = None,
    mode: str = "closest",
    filter_fn: Optional[Callable] = None,
    config: TraceConfig = TraceConfig(),
) -> Hits:
    """Trace a ray batch on the stack engine, one shard per mesh entry
    (scene copied to each device).  A filter sees the caller's ray index
    (the reference's shards see their local row)."""
    parts = _ray_shards(scene, rays, mesh, lambda sc, r, s: _stack._trace_loop(
        sc, r, mode=mode, config=config, filter_fn=filter_fn, ray_offset=s))
    return Hits(**{f.name: _cat([getattr(h, f.name) for h in parts],
                                rays.device)
                   for f in dataclasses.fields(Hits)})


def trace_closest_sharded(scene, rays, mesh=None, filter_fn=None,
                          config=TraceConfig()):
    return trace_sharded(scene, rays, mesh, "closest", filter_fn, config)


def trace_any_sharded(scene, rays, mesh=None, filter_fn=None,
                      config=TraceConfig()):
    return trace_sharded(scene, rays, mesh, "any", filter_fn, config)


def trace_packets_sharded(
    packed: PackedScene,
    rays: Rays,
    mesh: Optional[Mesh] = None,
    mode: str = "closest",
    watertight: bool = True,
    interpret: bool = False,
    pkt: Optional[int] = None,
    dual: bool = False,
    sort_rays: Optional[bool] = None,
    filter_mask: Optional[int] = None,
) -> PacketHits:
    """trace_packets on each ray shard (tables copied to each device); the
    arguments go through trace_packets' checks.  Each ray's trace is
    independent of its batch, so the result equals trace_packets on the
    whole batch bit for bit.  Returns a PacketHits over the caller's
    tables."""
    parts = _ray_shards(packed, rays, mesh, lambda p, r, s: trace_packets(
        p, r, mode=mode, watertight=watertight, interpret=interpret,
        pkt=pkt, dual=dual, sort_rays=sort_rays, filter_mask=filter_mask))
    return _packet_hits(parts, rays, packed)


def trace_grid_sharded(
    grid,
    rays: Rays,
    mesh: Optional[Mesh] = None,
    mode: str = "closest",
    watertight: bool = True,
    interpret: bool = False,
    rounds: int = 10,
    skips: int = 3,
    unit: int = 128,
    caps=None,
    filter_mask: Optional[int] = None,
) -> PacketHits:
    """testing/grid.py's rounds engine on each ray shard (GridScene copied
    to each device): each shard groups its own rays by cell.  Calibrate
    caps on one shard's worth of a representative batch
    (testing.grid.calibrate_caps)."""
    parts = _ray_shards(grid, rays, mesh, lambda g, r, s: trace_packets_grid(
        g, r, mode=mode, watertight=watertight, interpret=interpret,
        rounds=rounds, skips=skips, unit=unit, caps=caps,
        filter_mask=filter_mask))
    return _packet_hits(parts, rays, grid.flat)


def trace_instanced_sharded(
    pscene,
    rays: Rays,
    mesh: Optional[Mesh] = None,
    max_candidates: int = 8,
    interpret: bool = False,
    exact: bool = True,
):
    """Closest hit over an instanced (TLAS/BLAS) scene, the
    PackedInstancedScene copied to each device and the ray batch split
    over the mesh -> (PacketHits, instance_index).

    Each shard runs the candidate pass and the grouped rounds on its rays.
    The exactness residual runs once, on the rays' device, over the
    gathered unproven rays of every shard, as the reference's does."""
    parts = _ray_shards(pscene, rays, mesh, lambda ps, r, s: (
        _inst._instanced_rounds(ps, r, max_candidates, DEFAULT_P, None,
                                None, False)[:2]))
    dev = rays.device
    best = {k: _cat([b[k] for b, _ in parts], dev) for k in parts[0][0]}
    if exact:
        _inst._residual(_on(pscene, dev), rays, best,
                        _cat([u for _, u in parts], dev))
    packed = pscene.packed
    hits = PacketHits(
        hit=best["slot"] >= 0, t=best["t"], u_k=best["u"], v_k=best["v"],
        slot=best["slot"], origin=rays.origin, direction=rays.direction,
        tri_v=packed.tri_v, tri_vidx=packed.tri_vidx,
        tri_mesh=packed.tri_mesh, tri_prim=packed.tri_prim,
        instance=best["inst"],
        object_from_world=pscene.iscene.object_from_world.to(dev))
    return hits, best["inst"]


# ---------------------------------------------------------------------------
# Scene sharding: spatial partition, one sub-scene per scene row.
# ---------------------------------------------------------------------------

_STACKED = ("nodes", "tris", "tri_v", "tri_vidx", "tri_mesh", "tri_prim")


@dataclasses.dataclass
class ShardedScene:
    """One packed sub-scene per part, padded to common table shapes.

    parts[r] is a PackedScene on the device of the mesh's scene row r.
    Its tables are padded to the largest part's row counts: NaN rows in
    `tris` (never hit), zero rows in `nodes` and `tri_v`, and -1 in
    tri_vidx, tri_mesh and tri_prim; no traversal reaches them (each
    part's root is its row 0).  The stacked properties (nodes, tris,
    tri_v, tri_vidx, tri_mesh, tri_prim) are the reference's (D, ...)
    tables, on the first part's device.  A hit's slot in the parts'
    tables laid end to end is rank * part_tris + its slot in its part.
    """

    parts: tuple  # (D,) PackedScene
    num_tris: int  # total real triangles
    leaf_size: int

    @property
    def num_parts(self) -> int:
        return len(self.parts)

    @property
    def part_tris(self) -> int:
        """Padded triangle slots per part (slot globalisation stride)."""
        return self.parts[0].tri_v.shape[0]

    def _stacked(self, name: str) -> torch.Tensor:
        dev = self.parts[0].device
        return torch.stack([getattr(p, name).to(dev) for p in self.parts])

    nodes = property(lambda self: self._stacked("nodes"))
    tris = property(lambda self: self._stacked("tris"))
    tri_v = property(lambda self: self._stacked("tri_v"))
    tri_vidx = property(lambda self: self._stacked("tri_vidx"))
    tri_mesh = property(lambda self: self._stacked("tri_mesh"))
    tri_prim = property(lambda self: self._stacked("tri_prim"))


def partition_soup(tri_pos: np.ndarray, n_parts: int):
    """Recursive longest-axis median split of triangle centroids.

    Returns a list of n_parts index arrays (disjoint, covering all
    triangles, each non-empty when T >= n_parts)."""
    if tri_pos.shape[0] < n_parts:
        raise ValueError(
            f"partition_soup: {tri_pos.shape[0]} triangles cannot fill "
            f"{n_parts} non-empty parts — scene sharding needs at least "
            "one triangle per device (use ray sharding for tiny scenes)")
    cent = tri_pos.mean(axis=1)  # (T, 3)
    parts = [np.arange(tri_pos.shape[0])]
    while len(parts) < n_parts:
        # split the largest part
        parts.sort(key=len, reverse=True)
        idx = parts.pop(0)
        c = cent[idx]
        axis = int(np.argmax(c.max(axis=0) - c.min(axis=0)))
        order = np.argsort(c[:, axis], kind="stable")
        half = idx.shape[0] // 2
        parts.append(idx[order[:half]])
        parts.append(idx[order[half:]])
    return parts


def _scene_rows(mesh: Mesh) -> list:
    """The device that holds each scene row's part: the mesh's entries on
    a 1-D mesh, the first entry of each row on a hybrid one."""
    return list(mesh.devices.reshape(mesh.devices.shape[0], -1)[:, 0])


def _pad_rows(a: torch.Tensor, n: int, fill) -> torch.Tensor:
    pad = n - a.shape[0]
    return a if pad == 0 else torch.cat(
        [a, a.new_full((pad,) + tuple(a.shape[1:]), fill)])


def _padded(p: PackedScene, nd_rows: int, tp: int) -> PackedScene:
    w = p.branching
    return dataclasses.replace(
        p, nodes=_pad_rows(p.nodes, nd_rows, 0),
        meta=_pad_rows(p.meta, nd_rows // w, 0),
        slot_src=_pad_rows(p.slot_src, nd_rows // w, -1),
        tris=_pad_rows(p.tris, tp, float("nan")),
        tri_v=_pad_rows(p.tri_v, tp, 0.0),
        tri_vidx=_pad_rows(p.tri_vidx, tp, -1),
        tri_mesh=_pad_rows(p.tri_mesh, tp, -1),
        tri_prim=_pad_rows(p.tri_prim, tp, -1),
        tri_perm=_pad_rows(p.tri_perm, tp, -1))


def build_scene_sharded(meshes, mesh: Optional[Mesh] = None,
                        config: Optional[BuildConfig] = None
                        ) -> ShardedScene:
    """Build one packed sub-scene per scene row of `mesh` from a spatial
    partition (partition_soup), each with build_from_soup and pack_scene on
    its row's device (default config: BuildConfig(branching=8,
    leaf_size=8)).  Accepts the same mesh inputs as build_scene; pass the
    result to trace_*_scene_sharded with the same Mesh."""
    if mesh is None:
        mesh = default_mesh()
    if config is None:
        config = BuildConfig(branching=8, leaf_size=8)
    rows = _scene_rows(mesh)
    soup = meshes if isinstance(meshes, TriangleSoup) else build_soup(meshes)
    tri_pos = np.asarray(soup.tri_pos)
    packs = [pack_scene(build_from_soup(
        tri_pos[idx], tri_vidx=np.asarray(soup.tri_vidx)[idx],
        tri_mesh=np.asarray(soup.tri_mesh)[idx],
        tri_prim=np.asarray(soup.tri_prim)[idx], config=config, device=dev))
        for idx, dev in zip(partition_soup(tri_pos, len(rows)), rows)]
    nd_rows = max(p.nodes.shape[0] for p in packs)
    tp = max(p.tri_v.shape[0] for p in packs)
    return ShardedScene(parts=tuple(_padded(p, nd_rows, tp) for p in packs),
                        num_tris=int(tri_pos.shape[0]),
                        leaf_size=config.leaf_size)


def _combine(mode: str, t, u, v, slot, part_tris: int):
    """The reference's hit combine over the scene axis (shard.py:462-505)
    on (P, N) per-part results -> (hit, t, u, v, slot) per ray, the slot
    globalised to rank * part_tris + local slot.

    closest: the nearest t over the parts; among the parts that reach it
    the lowest rank gives u, v and the slot.  any: the lowest rank that
    hits gives its whole record, so (t, u, v, slot) always describe one
    intersection, never fields of two parts; a miss keeps the miss t
    (max_t, the same in every part).
    """
    p = t.shape[0]
    rank = torch.arange(p, device=t.device)[:, None]
    hit_p = slot >= 0
    gslot = torch.where(hit_p, rank * part_tris + slot, -1)
    if mode == "any":
        win = hit_p
    else:
        best_t = t.min(dim=0).values
        win = t <= best_t
    brank = torch.where(win, rank, p).min(dim=0).values
    found = brank < p

    def take(a, fill):
        return torch.where(found, a.gather(0, brank.clamp(max=p - 1)[None])[0],
                           fill)

    slot = take(gslot, -1).to(torch.int32)
    hit = slot >= 0
    if mode == "any":
        t_out = torch.where(hit, take(t, 0.0), t[0])
    else:
        t_out = best_t
    return hit, t_out, take(u, 0.0), take(v, 0.0), slot


def trace_scene_sharded(
    sscene: ShardedScene,
    rays: Rays,
    mesh: Optional[Mesh] = None,
    mode: str = "closest",
    watertight: bool = True,
    interpret: bool = False,
) -> PacketHits:
    """Trace against a scene sharded over the mesh's first axis.

    On a 1-D mesh every part traces the whole batch on its device; on a
    2-axis ("scene", "rays") mesh (hybrid_mesh) the batch also splits over
    the second axis, part r's tables copied to each device of row r.  The
    per-part results gather on the rays' device, where _combine picks each
    ray's record.  Returns a lazy PacketHits over the parts' tables laid
    end to end (slots globalised as rank * part_tris + local_slot)."""
    if mesh is None:
        mesh = default_mesh()
    grid = mesh.devices.reshape(mesh.devices.shape[0], -1)
    if grid.shape[0] != sscene.num_parts:
        raise ValueError(f"a scene of {sscene.num_parts} parts on a mesh "
                         f"of {grid.shape[0]} scene rows")
    spans = _spans(rays.count, grid.shape[1])
    traced = []
    for part, row in zip(sscene.parts, grid):
        copies = {d: _on(part, d) for d in set(row)}
        traced.append([trace_packets(copies[d], _on(rays[s:e], d),
                                     mode=mode, watertight=watertight,
                                     interpret=interpret)
                       for d, (s, e) in zip(row, spans)])
    dev = rays.device
    t, u, v, slot = (torch.stack([_cat([getattr(h, f) for h in hs], dev)
                                  for hs in traced])
                     for f in ("t", "u_k", "v_k", "slot"))
    hit, t, u, v, slot = _combine(mode, t, u, v, slot, sscene.part_tris)
    return PacketHits(
        hit=hit, t=t, u_k=u, v_k=v, slot=slot, origin=rays.origin,
        direction=rays.direction,
        **{f: _cat([getattr(p, f) for p in sscene.parts], dev)
           for f in ("tri_v", "tri_vidx", "tri_mesh", "tri_prim")})


def trace_closest_scene_sharded(sscene, rays, mesh=None, watertight=True,
                                interpret=False):
    return trace_scene_sharded(sscene, rays, mesh, "closest", watertight,
                               interpret)


def trace_any_scene_sharded(sscene, rays, mesh=None, watertight=True,
                            interpret=False):
    return trace_scene_sharded(sscene, rays, mesh, "any", watertight,
                               interpret)

"""Core batched types: rays and hit records (SoA dataclasses of tensors).

Parity notes (reference rtk.h, and rtk_tpu/types.py):
  * rtk_ray (rtk.h:29-34): origin, direction, min_t, max_t, batched into
    tensors of shape (N, 3) / (N,).
  * rtk_hit (rtk.h:36-43): t, u, v, three full vertex records, mesh_index,
    triangle_index, plus an explicit `hit` mask.
  * Barycentric convention matches rtk.c:363-375: u weights vertex[0],
    v weights vertex[1], w = 1-u-v weights vertex[2].
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from rtk_tpu_torch.utils.stats import span

RTK_INF = float(np.float32(3.402823e38))  # rtk.h:11


def _f32(a, device):
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=torch.float32)
    return torch.tensor(np.asarray(a, np.float32), device=device)


@dataclasses.dataclass
class Rays:
    """A batch of rays, SoA."""

    origin: torch.Tensor  # (N, 3) f32
    direction: torch.Tensor  # (N, 3) f32
    min_t: torch.Tensor  # (N,) f32
    max_t: torch.Tensor  # (N,) f32

    @staticmethod
    def make(origin, direction, min_t=None, max_t=None,
             device=None) -> "Rays":
        """Broadcast arrays or tensors into a Rays batch on `device`
        (default: the origin tensor's device, else the card)."""
        if device is None:
            device = (origin.device if isinstance(origin, torch.Tensor)
                      else "cuda")
        origin = _f32(origin, device)
        direction = _f32(direction, device)
        if origin.ndim == 1:
            origin = origin[None]
        if direction.ndim == 1:
            direction = direction[None]
        n = max(origin.shape[0], direction.shape[0])
        origin = origin.expand(n, 3).contiguous()
        direction = direction.expand(n, 3).contiguous()
        if min_t is None:
            min_t = torch.zeros((n,), dtype=torch.float32, device=device)
        else:
            min_t = _f32(min_t, device).expand(n).contiguous()
        if max_t is None:
            max_t = torch.full((n,), RTK_INF, dtype=torch.float32,
                               device=device)
        else:
            max_t = _f32(max_t, device).expand(n).contiguous()
        return Rays(origin=origin, direction=direction, min_t=min_t,
                    max_t=max_t)

    @property
    def count(self) -> int:
        return self.origin.shape[0]

    @property
    def device(self) -> torch.device:
        return self.origin.device

    def __getitem__(self, idx) -> "Rays":
        return Rays(*(getattr(self, f.name)[idx]
                      for f in dataclasses.fields(self)))


@dataclasses.dataclass
class Hits:
    """Hit records for a batch of rays, SoA.

    Misses have hit=False, t == ray.max_t, u = v = 0, indices == -1.
    """

    hit: torch.Tensor  # (N,) bool
    t: torch.Tensor  # (N,) f32
    u: torch.Tensor  # (N,) f32 barycentric weight of vertex[0]
    v: torch.Tensor  # (N,) f32 barycentric weight of vertex[1]
    mesh_index: torch.Tensor  # (N,) i32
    triangle_index: torch.Tensor  # (N,) i32 triangle index within its mesh
    vertex_position: torch.Tensor  # (N, 3, 3) f32
    vertex_index: torch.Tensor  # (N, 3) i32 original vertex indices

    @property
    def count(self) -> int:
        return self.t.shape[0]

    @property
    def w(self) -> torch.Tensor:
        """Barycentric weight of vertex[2]."""
        return 1.0 - self.u - self.v

    def position(self) -> torch.Tensor:
        """Interpolated hit position: u*v0 + v*v1 + w*v2. (N, 3)."""
        w = (1.0 - self.u - self.v)[:, None]
        return (self.u[:, None] * self.vertex_position[:, 0]
                + self.v[:, None] * self.vertex_position[:, 1]
                + w * self.vertex_position[:, 2])

    def __getitem__(self, idx) -> "Hits":
        return Hits(*(getattr(self, f.name)[idx]
                      for f in dataclasses.fields(self)))


@dataclasses.dataclass
class HitCandidate:
    """A candidate hit as a filter callable sees it (rtk_filter_fn,
    rtk.h:117): it returns True to accept.  The stack engine passes (N, K)
    tensors, the packet trace's plain version (rays, K) tensors, and
    jit_filter symbolic fields.  t, u, v are float32; mesh_index,
    triangle_index and ray_index (the caller's row) int32."""

    t: torch.Tensor
    u: torch.Tensor
    v: torch.Tensor
    mesh_index: torch.Tensor
    triangle_index: torch.Tensor
    ray_index: torch.Tensor


@dataclasses.dataclass
class PacketHits:
    """Lazily assembled hit records from the packet kernel.

    The kernel returns (t, u, v, slot) per ray; the rest of the rtk_hit
    record (mesh/triangle indices, vertex records) is gathered from the
    packed triangle tables on property access.  `.full()` materialises a
    plain Hits.  `slot` indexes the packed tables carried alongside (the
    scene's own tensors, not copies).  Each gather, and the u/v
    recompute, is a span `rtk.hits.<field>` (`rtk.hits.uv`).

    An instanced record (instancing.py) holds vertex positions in the
    object space of each ray's hit instance, and carries that instance and
    the instances' object_from_world table, so that a shade pass can map
    its normal to world space; both are None on a flat record.
    """

    hit: torch.Tensor  # (N,) bool
    t: torch.Tensor  # (N,) f32
    u_k: torch.Tensor  # (N,) f32 kernel u (zeros when uv_deferred)
    v_k: torch.Tensor  # (N,) f32
    slot: torch.Tensor  # (N,) i32 packed triangle slot, -1 = miss
    origin: torch.Tensor  # (N, 3) f32 the traced rays (for position())
    direction: torch.Tensor  # (N, 3) f32
    tri_v: torch.Tensor  # (Tp, 3, 3) f32 packed tables
    tri_vidx: torch.Tensor  # (Tp, 3) i32
    tri_mesh: torch.Tensor  # (Tp,) i32
    tri_prim: torch.Tensor  # (Tp,) i32
    # defer_uv traces carry no u/v out of the kernel; .u/.v re-run the
    # same watertight shear test against the one winning triangle.
    uv_deferred: bool = False
    instance: torch.Tensor | None = None  # (N,) i32 hit instance, -1 = miss
    object_from_world: torch.Tensor | None = None  # (I, 3, 4) f32

    @property
    def count(self) -> int:
        return self.t.shape[0]

    @property
    def u(self) -> torch.Tensor:
        return self.u_k if not self.uv_deferred else self._uv()[0]

    @property
    def v(self) -> torch.Tensor:
        return self.v_k if not self.uv_deferred else self._uv()[1]

    def _uv(self) -> tuple[torch.Tensor, torch.Tensor]:
        """Recompute (u, v) for the accepted hits with the kernel's leaf
        arithmetic (rtk.c:181-388), so they equal the carried values."""
        from rtk_tpu_torch.ops.intersect import intersect_triangles, ray_shear

        with span("rtk.hits.uv"):
            tri = self.tri_v[self._safe_slot]  # (N, 3, 3)
            n = self.t.shape[0]
            dev = self.t.device
            _, u, v, _ = intersect_triangles(
                self.origin, ray_shear(self.direction), tri[:, None],
                torch.full((n,), -float("inf"), device=dev),
                torch.full((n,), float("inf"), device=dev))
            zero = torch.zeros((), device=dev)
            return (torch.where(self.hit, u[:, 0], zero),
                    torch.where(self.hit, v[:, 0], zero))

    @property
    def w(self) -> torch.Tensor:
        return 1.0 - self.u - self.v

    @property
    def _safe_slot(self) -> torch.Tensor:
        return self.slot.clamp(0, self.tri_mesh.shape[0] - 1).long()

    def _masked(self, name, table, fill):
        with span(name):
            g = table[self._safe_slot]
            m = self.hit.reshape((-1,) + (1,) * (g.ndim - 1))
            return torch.where(m, g, torch.full((), fill, dtype=g.dtype,
                                                device=g.device))

    @property
    def mesh_index(self) -> torch.Tensor:
        return self._masked("rtk.hits.mesh_index", self.tri_mesh, -1)

    @property
    def triangle_index(self) -> torch.Tensor:
        return self._masked("rtk.hits.triangle_index", self.tri_prim, -1)

    @property
    def vertex_position(self) -> torch.Tensor:
        return self._masked("rtk.hits.vertex_position", self.tri_v, 0.0)

    @property
    def vertex_index(self) -> torch.Tensor:
        return self._masked("rtk.hits.vertex_index", self.tri_vidx, -1)

    def position(self) -> torch.Tensor:
        """Hit position o + t*d (N, 3); zeros on a miss."""
        p = self.origin + self.t[:, None] * self.direction
        return torch.where(self.hit[:, None], p, torch.zeros((), device=p.device))

    def full(self) -> Hits:
        """Materialise a plain Hits record (pays the assembly gathers)."""
        return Hits(hit=self.hit, t=self.t, u=self.u, v=self.v,
                    mesh_index=self.mesh_index,
                    triangle_index=self.triangle_index,
                    vertex_position=self.vertex_position,
                    vertex_index=self.vertex_index)

    def __getitem__(self, idx) -> "PacketHits":
        per_ray = ("hit", "t", "u_k", "v_k", "slot", "origin", "direction")
        if self.instance is not None:
            per_ray += ("instance",)
        return dataclasses.replace(
            self, **{f: getattr(self, f)[idx] for f in per_ray})


def miss_hits(n: int, device="cuda") -> Hits:
    """An all-miss Hits batch (t at the rtk +inf sentinel)."""
    i32 = dict(dtype=torch.int32, device=device)
    f32 = dict(dtype=torch.float32, device=device)
    return Hits(
        hit=torch.zeros((n,), dtype=torch.bool, device=device),
        t=torch.full((n,), RTK_INF, **f32),
        u=torch.zeros((n,), **f32),
        v=torch.zeros((n,), **f32),
        mesh_index=torch.full((n,), -1, **i32),
        triangle_index=torch.full((n,), -1, **i32),
        vertex_position=torch.zeros((n, 3, 3), **f32),
        vertex_index=torch.full((n, 3), -1, **i32),
    )

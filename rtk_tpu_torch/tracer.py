"""Tracer: the query front-end over a built Scene.

The scene's kernel tables are packed once, on first use, and cached on the
Tracer.  Queries run through ops/packet_trace.trace_packets: the CUDA
kernel for a scene on a CUDA device, its plain PyTorch version for a scene
on the CPU.  rtk_tpu's other engines are not ported yet; asking for one
raises and names its ROADMAP item.
"""
from __future__ import annotations

from typing import Callable, Optional

from rtk_tpu_torch.config import TraceConfig
from rtk_tpu_torch.scene import Scene
from rtk_tpu_torch.types import PacketHits, Rays

# rtk_tpu engines that wait for a later port, with their ROADMAP items.
_LATER_ENGINES = {
    "stack": "A11", "stackless": "A12", "binned": "A12", "grid": "A12",
    "march": "A12",
}


class Tracer:
    def __init__(self, scene: Scene, engine: str = "auto",
                 config: TraceConfig = TraceConfig(), tri_mask=None):
        """tri_mask: optional (num_tris,) per-triangle filter bits (soup
        order, 24 bits).  Queries passing filter_mask=m then test only
        triangles with (tri_mask & m) != 0."""
        if engine in _LATER_ENGINES:
            raise NotImplementedError(
                f"engine {engine!r} is not ported yet (ROADMAP "
                f"{_LATER_ENGINES[engine]}); use engine='packet'")
        if engine not in ("auto", "packet"):
            raise ValueError(f"unknown engine {engine!r}")
        if scene.branching != 8:
            raise ValueError("packet engine requires branching=8 scenes")
        self.scene = scene
        self.config = config
        self.tri_mask = tri_mask
        self.engine = "packet"
        self._packed = None

    @property
    def packed(self):
        if self._packed is None:
            from rtk_tpu_torch.trace.packed import pack_scene

            self._packed = pack_scene(self.scene, tri_mask=self.tri_mask)
        return self._packed

    def _trace(self, rays: Rays, mode: str, filter_fn: Optional[Callable],
               filter_mask: Optional[int]) -> PacketHits:
        if filter_fn is not None:
            raise NotImplementedError(
                "filter_fn callables are not ported yet (ROADMAP K1 "
                "filter_fn, A11 stack engine); use tri_mask + filter_mask")
        from rtk_tpu_torch.ops.packet_trace import trace_packets

        return trace_packets(self.packed, rays, mode=mode,
                             watertight=self.config.watertight,
                             filter_mask=filter_mask,
                             defer_uv=self.config.defer_uv)

    def closest(self, rays: Rays, filter_fn: Optional[Callable] = None,
                coherent: Optional[bool] = None,
                filter_mask: Optional[int] = None) -> PacketHits:
        """Nearest-hit query (rtk_trace_ray).  `coherent` is the TPU
        engine's stepping hint and has no effect here; `filter_mask` runs
        the built-in mask filter."""
        return self._trace(rays, "closest", filter_fn, filter_mask)

    def any(self, rays: Rays, filter_fn: Optional[Callable] = None,
            coherent: Optional[bool] = None,
            filter_mask: Optional[int] = None) -> PacketHits:
        """Any-hit query (the intended rtk_trace_ray_filter semantics)."""
        return self._trace(rays, "any", filter_fn, filter_mask)

"""Tracer: the engine-selecting query front-end over a built Scene.

Six engines implement the same hit-record contract (rtk_trace_ray,
rtk.c:543-577):

  * "packet": ops/packet_trace.trace_packets over the scene's kernel
    tables (packed once, on first use, and cached here): the CUDA kernel
    for a scene on a CUDA device, its plain PyTorch version on the CPU.
    Needs branching=8 scenes.
  * "stack": trace/stack.py's lockstep traversal in plain PyTorch on the
    scene's device; any branching, and any filter callable.
  * "stackless": trace/stackless.py's skip-link walk over a DFS-preorder
    entity table (built once, on first use), plain PyTorch as rtk_tpu's is
    plain XLA.
  * "binned": testing/binned.py's rounds over subtree bins of the packed
    tables, through the kernel's roots variant, and a full-tree residual.
  * "grid": testing/grid.py's rounds engine over a macro-grid (built once
    from the scene and its packed tables, on first use), through the
    kernel's roots variant, and a full-tree residual.
  * "march": testing/grid.py's fused grid march (the kernel's march
    instantiation on the card) over a grid with one root row per cell.

filter_mask runs on the packet-kernel engines (packet, binned, grid,
march); the grid's per-cell tables carry the mask too.  "auto" is
"packet" for branching-8 scenes and "stack" otherwise.  A filter callable
marked with jit_filter runs inside the kernel's filter variant on the
packet engine; any other filter callable routes to the stack engine,
which calls it on real tensors (rtk_tpu/tracer.py:111-199).

Each query is one span, `rtk.tracer.closest` or `rtk.tracer.any`
(utils/stats.py::span), the root of the call's spans while a profiler
records; the record's lazy gathers (`rtk.hits.*`) follow it.
"""
from __future__ import annotations

from typing import Callable, Optional, Union

from rtk_tpu_torch.config import TraceConfig
from rtk_tpu_torch.ops.filter_capture import JitFilter, jit_filter
from rtk_tpu_torch.scene import Scene
from rtk_tpu_torch.types import Hits, PacketHits, Rays
from rtk_tpu_torch.utils.stats import span

AnyHits = Union[Hits, PacketHits]

__all__ = ["Tracer", "jit_filter"]


class Tracer:
    def __init__(self, scene: Scene, engine: str = "auto",
                 config: TraceConfig = TraceConfig(), tri_mask=None):
        """tri_mask: optional (num_tris,) per-triangle filter bits (soup
        order, 24 bits).  Queries passing filter_mask=m then test only
        triangles with (tri_mask & m) != 0 (packet engine)."""
        if engine not in ("auto", "packet", "stack", "stackless", "binned",
                          "grid", "march"):
            raise ValueError(f"unknown engine {engine!r}")
        eligible = scene.branching == 8
        if engine == "packet" and not eligible:
            raise ValueError("packet engine requires branching=8 scenes")
        self.scene = scene
        self.config = config
        self.tri_mask = tri_mask
        self.engine = (engine if engine != "auto"
                       else ("packet" if eligible else "stack"))
        self._packed = None
        self._grid = None
        self._stackless = None

    @property
    def packed(self):
        if self._packed is None:
            from rtk_tpu_torch.trace.packed import pack_scene

            self._packed = pack_scene(self.scene, tri_mask=self.tri_mask)
        return self._packed

    @property
    def grid(self):
        """The grid and march engines' macro-grid (testing/grid.py
        GridScene), built from the scene and its packed tables on first
        use: with the march's one-root-per-cell forest for the march
        engine, without it otherwise (the rounds engine does not read it,
        and reuses a grid that has it)."""
        march = self.engine == "march"
        if self._grid is None or (march and self._grid.cells_march is None):
            from rtk_tpu_torch.testing.grid import build_grid_from_scene

            # self.packed carries the tri_mask column; the per-cell tables
            # get it packed in too.
            self._grid = build_grid_from_scene(
                self.scene, packed=self.packed, tri_mask=self.tri_mask,
                march=march)
        return self._grid

    @property
    def stackless(self):
        """The stackless engine's entity table (trace/stackless.py), built
        from the scene on first use."""
        if self._stackless is None:
            from rtk_tpu_torch.trace.stackless import build_stackless

            self._stackless = build_stackless(self.scene)
        return self._stackless

    def refresh(self, scene: Scene) -> "Tracer":
        """Rebind to a refit Scene (same topology): the same config, mask
        and engine; packed tables, if they were built, get their bounds
        and vertices regathered on the device, never rebuilt.  The grid
        and the stackless table depend on the bounds, so they are dropped
        and built again on next use."""
        t = Tracer.__new__(Tracer)
        t.scene = scene
        t.config = self.config
        t.tri_mask = self.tri_mask
        t.engine = self.engine
        t._packed = None
        t._grid = None
        t._stackless = None
        if self._packed is not None:
            from rtk_tpu_torch.trace.packed import repack_bounds

            t._packed = repack_bounds(self._packed, scene)
        return t

    def _trace(self, rays: Rays, mode: str, filter_fn: Optional[Callable],
               filter_mask: Optional[int]) -> AnyHits:
        if self.engine == "packet" and (filter_fn is None
                                        or isinstance(filter_fn, JitFilter)):
            from rtk_tpu_torch.ops.packet_trace import trace_packets

            return trace_packets(self.packed, rays, mode=mode,
                                 watertight=self.config.watertight,
                                 filter_mask=filter_mask,
                                 filter_fn=filter_fn,
                                 defer_uv=self.config.defer_uv)
        if filter_fn is None:
            wt = self.config.watertight
            if self.engine == "march":
                from rtk_tpu_torch.testing.grid import trace_packets_march

                return trace_packets_march(self.grid, rays, mode=mode,
                                           watertight=wt,
                                           filter_mask=filter_mask)
            if self.engine == "grid":
                from rtk_tpu_torch.testing.grid import trace_packets_grid

                return trace_packets_grid(self.grid, rays, mode=mode,
                                          watertight=wt,
                                          filter_mask=filter_mask)
            if self.engine == "binned":
                from rtk_tpu_torch.testing.binned import trace_packets_binned

                return trace_packets_binned(self.packed, rays, mode=mode,
                                            watertight=wt,
                                            filter_mask=filter_mask)
        if filter_mask is not None:
            raise ValueError(
                "filter_mask runs on the packet-kernel engines only "
                "(packet/binned/grid/march); use filter_fn on the stack "
                "engine")
        if self.engine == "stackless" and filter_fn is None:
            from rtk_tpu_torch.trace.stackless import trace_stackless

            return trace_stackless(self.stackless, rays, mode=mode,
                                   watertight=self.config.watertight)
        from rtk_tpu_torch.trace import stack

        fn = stack.trace_closest if mode == "closest" else stack.trace_any
        return fn(self.scene, rays, filter_fn=filter_fn, config=self.config)

    def closest(self, rays: Rays, filter_fn: Optional[Callable] = None,
                coherent: Optional[bool] = None,
                filter_mask: Optional[int] = None) -> AnyHits:
        """Nearest-hit query (rtk_trace_ray).  `coherent` is the TPU
        engine's stepping hint and has no effect here; `filter_mask` runs
        the built-in mask filter; `filter_fn` (HitCandidate -> bool) keeps
        or rejects candidates (jit_filter-marked: in the kernel)."""
        with span("rtk.tracer.closest"):
            return self._trace(rays, "closest", filter_fn, filter_mask)

    def any(self, rays: Rays, filter_fn: Optional[Callable] = None,
            coherent: Optional[bool] = None,
            filter_mask: Optional[int] = None) -> AnyHits:
        """Any-hit query (the intended rtk_trace_ray_filter semantics)."""
        with span("rtk.tracer.any"):
            return self._trace(rays, "any", filter_fn, filter_mask)

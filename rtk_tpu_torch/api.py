"""Public API: build scenes and trace ray batches (PyTorch / CUDA).

Mirrors rtk_tpu.api (rtk.h:119-130 in batched form):
    rtk_build_scene      -> build_scene(meshes, device=...) -> Scene
    rtk_trace_ray        -> Tracer(scene).closest(rays) / .any(rays), or
                            trace_closest / trace_any (stack engine)
    rtk_trace_ray_filter -> the same with filter_fn= (jit_filter marks a
                            predicate for the kernel's filter variant)
    (no rtk counterpart)  -> refit(scene, new_tri_pos): deformed vertices,
                            same topology; Tracer.refresh(scene) rebinds
    the rtk blob         -> save_scene / load_scene and the packed and
                            instanced forms, load_any
    instancing           -> build_instanced -> pack_instanced ->
                            trace_closest_instanced_packets
The task lifecycle (rtk_start_build ... rtk_finish_build_to) is
rtk_tpu_torch.tasks, and the ten rtk entry points rtk_tpu_torch.compat.
Builders and loaders put the scene on the card unless `device` says
otherwise.
"""
from __future__ import annotations

from rtk_tpu_torch.builder.sah import build_sah_packed
from rtk_tpu_torch.config import BuildConfig, TraceConfig
from rtk_tpu_torch.instancing import (build_instanced, pack_instanced,
                                      trace_closest_instanced,
                                      trace_closest_instanced_packets)
from rtk_tpu_torch.mesh import MeshDesc, TriangleSoup, build_soup
from rtk_tpu_torch.scene import Scene, build_from_soup, refit
from rtk_tpu_torch.trace.stack import trace_any, trace_closest
from rtk_tpu_torch.tracer import Tracer, jit_filter
from rtk_tpu_torch.types import HitCandidate, Hits, PacketHits, Rays
from rtk_tpu_torch.utils.serialize import (load_any, load_instanced_scene,
                                           load_packed_scene, load_scene,
                                           save_instanced_scene,
                                           save_packed_scene, save_scene)


def build_scene(meshes, config: BuildConfig = BuildConfig(),
                device="cuda") -> Scene:
    """Build a Scene from one or more meshes on `device`.

    Accepts a MeshDesc, a (positions, indices) tuple, a TriangleSoup, or a
    sequence of the first two.  Decode runs on the host (strides, dtypes,
    callbacks, rtk.c:1028-1114 parity); the BVH build runs on `device`.
    """
    soup = meshes if isinstance(meshes, TriangleSoup) else build_soup(meshes)
    return build_from_soup(soup.tri_pos, soup.tri_vidx, soup.tri_mesh,
                           soup.tri_prim, config, device=device)


__all__ = [
    "BuildConfig", "TraceConfig", "MeshDesc", "TriangleSoup", "Rays", "Hits",
    "PacketHits", "HitCandidate", "Scene", "Tracer", "jit_filter",
    "build_scene", "build_sah_packed", "build_from_soup", "refit",
    "trace_closest",
    "trace_any", "save_scene", "load_scene", "save_packed_scene",
    "load_packed_scene", "save_instanced_scene", "load_instanced_scene",
    "load_any", "build_instanced", "pack_instanced",
    "trace_closest_instanced", "trace_closest_instanced_packets",
]

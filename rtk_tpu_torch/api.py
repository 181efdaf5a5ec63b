"""Public API: build scenes and trace ray batches (PyTorch / CUDA).

Mirrors rtk_tpu.api:
    rtk_build_scene -> build_scene(meshes, device=...) -> Scene
    rtk_trace_ray   -> Tracer(scene).closest(rays) / .any(rays)
    instancing      -> build_instanced -> pack_instanced ->
                       trace_closest_instanced_packets
"""
from __future__ import annotations

from rtk_tpu_torch.builder.sah import build_sah_packed
from rtk_tpu_torch.config import BuildConfig, TraceConfig
from rtk_tpu_torch.instancing import (build_instanced, pack_instanced,
                                      trace_closest_instanced,
                                      trace_closest_instanced_packets)
from rtk_tpu_torch.mesh import MeshDesc, TriangleSoup, build_soup
from rtk_tpu_torch.scene import Scene, build_from_soup
from rtk_tpu_torch.tracer import Tracer
from rtk_tpu_torch.types import Hits, PacketHits, Rays


def build_scene(meshes, config: BuildConfig = BuildConfig(),
                device="cpu") -> Scene:
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
    "PacketHits", "Scene", "Tracer", "build_scene", "build_sah_packed",
    "build_from_soup", "build_instanced", "pack_instanced",
    "trace_closest_instanced", "trace_closest_instanced_packets",
]

"""rtk-compatible API shim (rtk_tpu.compat in PyTorch).

A user of the reference C library (rtk.h:119-130) can drive the port
through the same ten entry points, spelled the same way:

    rtk_start_build / rtk_run_task /          -> rtk_tpu_torch.tasks
        rtk_get_build_size /
        rtk_finish_build[_to]
    rtk_build_scene(desc)                      -> the task graph, drained
    rtk_free_scene                             -> no-op (garbage collected)
    rtk_trace_ray(scene, ray)                  -> Tracer(engine="stack")
                                                  .closest on one ray
    rtk_trace_ray_filter(scene, ray, fn, user) -> the same with filter_fn
                                                  (a stub in the reference,
                                                  rtk.c:579-582)

Types mirror rtk.h: RtkRay ~ rtk_ray (rtk.h:29-34), RtkHit ~ rtk_hit
(rtk.h:36-42, with its three vertex records), RtkMesh ~ rtk_mesh
(rtk.h:64-76), RtkSceneDesc ~ rtk_scene_desc (rtk.h:97-104 with log_fn).
Scenes are built on the card unless `device` says otherwise; single rays
are traced on the scene's device.  Batch rays through Tracer for speed.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import numpy as np

from rtk_tpu_torch import tasks as _tasks
from rtk_tpu_torch.config import BuildConfig
from rtk_tpu_torch.mesh import MeshDesc
from rtk_tpu_torch.scene import Scene
from rtk_tpu_torch.tracer import Tracer
from rtk_tpu_torch.types import Rays

RTK_INF = 3.402823e38

# rtk_type (rtk.h:45-52)
RTK_TYPE_DEFAULT = "default"
RTK_TYPE_F32 = "f32"
RTK_TYPE_F64 = "f64"
RTK_TYPE_REAL = "f32"
RTK_TYPE_U16 = "u16"
RTK_TYPE_U32 = "u32"


@dataclasses.dataclass
class RtkRay:
    """rtk_ray (rtk.h:29-34)."""

    origin: tuple
    direction: tuple
    min_t: float = 0.0
    max_t: float = RTK_INF


@dataclasses.dataclass
class RtkVertex:
    """rtk_vertex (rtk.h:24-27)."""

    position: tuple
    index: int


@dataclasses.dataclass
class RtkHit:
    """rtk_hit (rtk.h:36-42)."""

    t: float
    u: float
    v: float
    vertex: tuple  # 3 RtkVertex records
    mesh_index: int
    triangle_index: int


# rtk_mesh: MeshDesc is field-compatible (strided buffers with types,
# num_triangles, callbacks).
RtkMesh = MeshDesc


@dataclasses.dataclass
class RtkSceneDesc:
    """rtk_scene_desc (rtk.h:97-104)."""

    meshes: Sequence[MeshDesc]
    log_fn: Optional[Callable] = None
    log_user: object = None


def _desc_meshes(desc):
    if isinstance(desc, RtkSceneDesc):
        return list(desc.meshes), desc.log_fn, desc.log_user
    return list(desc), None, None


def rtk_start_build(desc, config: BuildConfig = BuildConfig(),
                    device="cuda"):
    """rtk_start_build (rtk.h:119) -> (build, first_tasks): one decode task
    per mesh rather than the reference's single chained task; run them
    all through rtk_run_task."""
    meshes, log_fn, log_user = _desc_meshes(desc)
    return _tasks.start_build(meshes, config, log_fn=log_fn,
                              log_user=log_user, device=device)


def rtk_run_task(task, queue) -> int:
    """rtk_run_task (rtk.h:120): run one task, append the tasks it spawns
    to the caller's queue, return how many it spawned."""
    return _tasks.run_task(task, queue)


def rtk_get_build_size(build) -> int:
    """rtk_get_build_size (rtk.h:122): serialized scene size in bytes."""
    return _tasks.get_build_size(build)


def rtk_finish_build(build) -> Scene:
    """rtk_finish_build (rtk.h:124)."""
    return _tasks.finish_build(build)


def rtk_finish_build_to(build, buffer) -> int:
    """rtk_finish_build_to (rtk.h:123): serialize into a caller buffer
    (the relocatable magic/endian/version container)."""
    return _tasks.finish_build_to(build, buffer)


def rtk_build_scene(desc, config: BuildConfig = BuildConfig(),
                    device="cuda") -> Scene:
    """rtk_build_scene (rtk.h:126): one-shot convenience build, the task
    graph drained on the calling thread."""
    meshes, log_fn, log_user = _desc_meshes(desc)
    return _tasks.build_scene_tasks(meshes, config, log_fn=log_fn,
                                    log_user=log_user, device=device)


def rtk_free_scene(scene) -> None:
    """rtk_free_scene (rtk.h:127): no-op; scenes are garbage collected."""


def _one_ray(ray: RtkRay, device) -> Rays:
    return Rays.make(np.asarray([ray.origin], np.float32),
                     np.asarray([ray.direction], np.float32),
                     min_t=np.asarray([ray.min_t], np.float32),
                     max_t=np.asarray([ray.max_t], np.float32),
                     device=device)


def _one_hit(hits) -> Optional[RtkHit]:
    if not bool(hits.hit[0]):
        return None
    vp = hits.vertex_position[0].cpu().numpy()
    vi = hits.vertex_index[0].cpu().numpy()
    return RtkHit(
        t=float(hits.t[0]), u=float(hits.u[0]), v=float(hits.v[0]),
        vertex=tuple(RtkVertex(tuple(vp[j]), int(vi[j])) for j in range(3)),
        mesh_index=int(hits.mesh_index[0]),
        triangle_index=int(hits.triangle_index[0]))


def rtk_trace_ray(scene: Scene, ray: RtkRay):
    """rtk_trace_ray (rtk.h:129) -> (hit_found, RtkHit | None): the nearest
    hit with t in the open window (min_t, max_t), rtk.c:543-577."""
    hits = Tracer(scene, engine="stack").closest(_one_ray(ray,
                                                          scene.device))
    hit = _one_hit(hits)
    return hit is not None, hit


def rtk_trace_ray_filter(scene: Scene, ray: RtkRay, filter_fn: Callable,
                         filter_user=None):
    """rtk_trace_ray_filter (rtk.h:130), implemented (the reference's is a
    stub returning true, rtk.c:579-582): filter_fn(user, ray, candidate)
    -> bool mask keeps or rejects candidate hits during traversal."""
    fn = None
    if filter_fn is not None:
        fn = lambda cand: filter_fn(filter_user, ray, cand)  # noqa: E731
    hits = Tracer(scene, engine="stack").closest(
        _one_ray(ray, scene.device), filter_fn=fn)
    hit = _one_hit(hits)
    return hit is not None, hit

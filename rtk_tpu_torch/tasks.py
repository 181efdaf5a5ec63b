"""Cooperative, host-driven build task system (rtk_tpu.tasks in PyTorch).

The reference never creates threads: rtk_start_build hands the host a first
task, the host calls rtk_run_task from as many threads as it likes, each run
may push follow-up tasks into a caller-provided queue, and phase transitions
ride an atomic counter (rtk.h:108-115; rtk.c:679-710, 1692-1717).

Here the BVH build is one device program (scene.py), so the tasks are what
still gains from host threads: per-mesh decode (strides, dtypes,
callbacks; one task per mesh), soup assembly, then the device build.

    build, first = start_build(meshes)         # rtk_start_build
    n = run_task(task, queue)                  # rtk_run_task -> #spawned
    size = get_build_size(build)               # rtk_get_build_size
    scene = finish_build(build)                # rtk_finish_build
    nbytes = finish_build_to(build, buffer)    # rtk_finish_build_to

Tasks carry a `cost` hint for the host scheduler, like rtk_task.cost
(rtk.h:112; rtk.c:1664-1667).  build_scene_tasks drains the graph on a
thread pool; unlike rtk_tpu's (tasks.py:214-218, which respawns workers
forever once one raises), the first exception a task raises propagates.
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
import io
import threading
from typing import Callable, List, Optional, Sequence

import numpy as np

from rtk_tpu_torch.config import BuildConfig
from rtk_tpu_torch.mesh import (MeshDesc, TriangleSoup, as_mesh_desc,
                                decode_indices, decode_positions)
from rtk_tpu_torch.scene import Scene, build_from_soup
from rtk_tpu_torch.utils.serialize import save_scene
from rtk_tpu_torch.utils.stats import BuildLogger

# Cost-model constants (per item), in the spirit of rtk.c:1664-1667.
COST_DECODE_PER_TRI = 1.0
COST_UPLOAD_PER_TRI = 0.25
COST_BUILD_PER_TRI = 0.5


@dataclasses.dataclass
class Task:
    """Parity: rtk_task (rtk.h:109-115)."""

    build: "Build"
    fn: Callable[["Task", List["Task"]], None]
    index: int = 0
    arg: object = None
    cost: float = 0.0


class Build:
    """Parity: rtk_build -- all in-flight state of one scene build."""

    def __init__(self, meshes: Sequence[MeshDesc], config: BuildConfig,
                 log_fn=None, log_user=None, device="cuda"):
        self.meshes = [as_mesh_desc(m) for m in meshes]
        self.config = config
        self.device = device
        self.logger = BuildLogger(log_fn, log_user, build=self)
        self._decoded: List[Optional[tuple]] = [None] * len(self.meshes)
        self._lock = threading.Lock()
        self._pending = 0  # analogue of a_tasks_left (rtk.c:1703-1714)
        self._phase = "decode"
        self.soup: Optional[TriangleSoup] = None
        self.scene: Optional[Scene] = None

    def _task_started(self, n: int):
        with self._lock:
            self._pending += n

    def _task_done(self) -> bool:
        """True when this completion drains the phase."""
        with self._lock:
            self._pending -= 1
            return self._pending == 0

    @property
    def total_tris(self) -> int:
        return sum(m.num_triangles for m in self.meshes)


def _decode_task(task: Task, queue: List[Task]):
    build = task.build
    m = build.meshes[task.index]
    idx = decode_indices(m)
    build._decoded[task.index] = (decode_positions(m, idx), idx)
    build.logger.log(f"decoded mesh {task.index}: {m.num_triangles} tris")
    if build._task_done():
        build._phase = "assemble"
        build._task_started(1)
        queue.append(Task(build, _assemble_task,
                          cost=COST_UPLOAD_PER_TRI * build.total_tris))


def _assemble_task(task: Task, queue: List[Task]):
    build = task.build
    pos, vidx, mids, prims = [], [], [], []
    for mi, (p, idx) in enumerate(build._decoded):
        t = p.shape[0]
        pos.append(p)
        vidx.append(idx.astype(np.int32))
        mids.append(np.full((t,), mi, np.int32))
        prims.append(np.arange(t, dtype=np.int32))
    build.soup = TriangleSoup(tri_pos=np.concatenate(pos),
                              tri_vidx=np.concatenate(vidx),
                              tri_mesh=np.concatenate(mids),
                              tri_prim=np.concatenate(prims))
    build.logger.log(f"assembled soup: {build.soup.num_triangles} tris")
    if build._task_done():
        build._phase = "device_build"
        build._task_started(1)
        queue.append(Task(build, _device_build_task,
                          cost=COST_BUILD_PER_TRI * build.total_tris))


def _device_build_task(task: Task, queue: List[Task]):
    build = task.build
    s = build.soup
    build.scene = build_from_soup(s.tri_pos, s.tri_vidx, s.tri_mesh,
                                  s.tri_prim, build.config,
                                  device=build.device)
    build.logger.log(f"device build done: {build.scene.num_leaves} leaves")
    if build._task_done():
        build._phase = "done"


def start_build(meshes, config: BuildConfig = BuildConfig(), log_fn=None,
                log_user=None, device="cuda"):
    """Parity: rtk_start_build (rtk.c:1625) -> (build, first_tasks).

    The host owns scheduling: run the returned tasks (and everything they
    push) from any number of threads, each with its own queue list.  The
    scene is built on `device`."""
    if isinstance(meshes, (MeshDesc, tuple)):
        meshes = [meshes]
    build = Build(meshes, config, log_fn, log_user, device)
    build.logger.log(f"start_build: {len(build.meshes)} meshes")
    tasks = [Task(build, _decode_task, index=i,
                  cost=COST_DECODE_PER_TRI * m.num_triangles)
             for i, m in enumerate(build.meshes)]
    build._task_started(len(tasks))
    return build, tasks


def run_task(task: Task, queue: List[Task]) -> int:
    """Parity: rtk_run_task (rtk.c:1692): run the task, append the tasks
    it spawns to `queue`, return how many it spawned."""
    before = len(queue)
    task.fn(task, queue)
    return len(queue) - before


def get_build_size(build: Build) -> int:
    """Parity: rtk_get_build_size (rtk.c:1719): serialized scene size."""
    if build.scene is None:
        raise RuntimeError("build not finished; run all tasks first")
    return save_scene(build.scene, io.BytesIO())


def finish_build(build: Build) -> Scene:
    """Parity: rtk_finish_build (rtk.c:1776)."""
    if build._phase != "done" or build.scene is None:
        raise RuntimeError("build tasks not drained")
    return build.scene


def finish_build_to(build: Build, buffer) -> int:
    """Parity: rtk_finish_build_to (rtk.c:1732): serialize into a writable
    file object or path; returns bytes written."""
    return save_scene(finish_build(build), buffer)


def _drain_threaded(tasks: List[Task], num_threads: int):
    """Run `tasks` and everything they spawn on `num_threads` threads.
    Returns when the graph is drained or a task raised; raises the first
    exception a task raised."""
    cond = threading.Condition()
    shared = list(tasks)
    running = 0
    errors: List[BaseException] = []

    def worker():
        nonlocal running
        while True:
            with cond:
                while not shared and running and not errors:
                    cond.wait()
                if errors or not shared:
                    cond.notify_all()
                    return
                task = shared.pop()
                running += 1
            local: List[Task] = []
            try:
                run_task(task, local)
            except Exception as e:  # handed to the caller below
                with cond:
                    errors.append(e)
                    running -= 1
                    cond.notify_all()
                return
            with cond:
                shared.extend(local)
                running -= 1
                cond.notify_all()

    with concurrent.futures.ThreadPoolExecutor(num_threads) as ex:
        futures = [ex.submit(worker) for _ in range(num_threads)]
    for fut in futures:
        fut.result()
    if errors:
        raise errors[0]


def build_scene_tasks(meshes, config: BuildConfig = BuildConfig(),
                      num_threads: int = 1, log_fn=None, log_user=None,
                      device="cuda") -> Scene:
    """Parity: rtk_build_scene (rtk.c:1788): drain the task graph, on a
    pool of `num_threads` host threads when more than one."""
    build, tasks = start_build(meshes, config, log_fn=log_fn,
                               log_user=log_user, device=device)
    if num_threads <= 1:
        queue = list(tasks)
        while queue:
            run_task(queue.pop(), queue)
    else:
        _drain_threaded(tasks, num_threads)
    return finish_build(build)

"""The rtk lifecycle in the port against rtk_tpu: the task graph (one
thread and a pool), the compat shim's ten entry points, single-ray
rtk_trace_ray / rtk_trace_ray_filter against rtk_tpu.compat's, and the
fault not to copy from rtk_tpu/tasks.py:214-218: a task that raises makes
build_scene_tasks raise instead of respawning workers forever."""
import io
import sys
import threading

import numpy as np
import pytest
import torch

from rtk_tpu import compat as jcompat
from rtk_tpu.mesh import MeshDesc as JaxMeshDesc
import rtk_tpu_torch as rt
from rtk_tpu_torch import compat, tasks
from rtk_tpu_torch.mesh import MeshDesc
from rtk_tpu_torch.testing import scenes
from rtk_tpu_torch.utils import serialize

from test_torch_trace import CPU, _soup_of

torch.set_num_threads(2)

JOIN_TIMEOUT_S = 60  # a build of a few hundred triangles takes well under


def _meshes():
    walls, boxes = scenes.cornell_box()[:10], scenes.cornell_box()[10:]
    return [_soup_of(walls), _soup_of(boxes)]


def _raw_mesh(cls):
    """cornell_box as one raw-buffer mesh (tests/test_compat.py:10-16)."""
    pos = scenes.cornell_box().reshape(-1, 3).astype(np.float32)
    idx = np.arange(pos.shape[0], dtype=np.uint32)
    return cls(positions=pos.tobytes(), indices=idx.tobytes(),
               num_triangles=pos.shape[0] // 3, position_type="f32",
               index_type="u32")


def _assert_scenes_equal(got, want):
    for f in serialize._FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b), f
    assert (got.num_tris, got.num_leaves, got.leaf_size) == (
        want.num_tris, want.num_leaves, want.leaf_size)


@pytest.mark.parametrize("threads", [1, 4])
def test_task_builds_equal_build_scene(threads):
    want = rt.build_scene(_meshes(), device=CPU)
    _assert_scenes_equal(tasks.build_scene_tasks(_meshes(),
                                                 num_threads=threads,
                                                 device=CPU), want)
    _assert_scenes_equal(compat.rtk_build_scene(
        compat.RtkSceneDesc(_meshes()), device=CPU), want)


def test_single_thread_lifecycle():
    logs, users = [], []
    build, first = tasks.start_build(
        _meshes(), log_fn=lambda u, b, s: (logs.append(s), users.append(u)),
        log_user="me", device=CPU)
    assert len(first) == 2 and all(t.cost > 0 for t in first)
    with pytest.raises(RuntimeError, match="not finished"):
        tasks.get_build_size(build)
    queue, spawned = list(first), 0
    while queue:
        spawned += tasks.run_task(queue.pop(), queue)
    assert spawned == 2  # assemble, then the device build
    scene = tasks.finish_build(build)
    assert scene.num_tris == 34
    assert any("decoded" in s for s in logs)
    assert any("device build" in s for s in logs)
    assert set(users) == {"me"}
    buf = io.BytesIO()
    n = tasks.finish_build_to(build, buf)
    assert n == tasks.get_build_size(build) == len(buf.getvalue())
    _assert_scenes_equal(rt.load_scene(buf.getvalue(), device=CPU), scene)


def test_finish_before_the_tasks_drain_raises():
    build, first = compat.rtk_start_build(_meshes(), device=CPU)
    compat.rtk_run_task(first[0], [])
    with pytest.raises(RuntimeError, match="not drained"):
        compat.rtk_finish_build(build)


def test_incremental_lifecycle_and_serialize():
    """tests/test_compat.py:44-55 on the port, and the port's blob equals
    rtk_tpu's for the same raw mesh."""
    build, first = compat.rtk_start_build([_raw_mesh(MeshDesc)], device=CPU)
    queue = list(first)
    while queue:
        compat.rtk_run_task(queue.pop(), queue)
    size = compat.rtk_get_build_size(build)
    buf = io.BytesIO()
    assert compat.rtk_finish_build_to(build, buf) == size == len(
        buf.getvalue())
    jbuild, jfirst = jcompat.rtk_start_build([_raw_mesh(JaxMeshDesc)])
    queue = list(jfirst)
    while queue:
        jcompat.rtk_run_task(queue.pop(), queue)
    jbuf = io.BytesIO()
    jcompat.rtk_finish_build_to(jbuild, jbuf)
    assert buf.getvalue() == jbuf.getvalue()
    compat.rtk_free_scene(compat.rtk_finish_build(build))


RAYS = [((0.5, 0.5, 2.2), (0.0, 0.0, -1.0)),
        ((0.5, 0.5, 5.0), (0.0, 0.0, 1.0)),  # points away: a miss
        ((0.2, 0.8, 2.0), (0.1, -0.3, -1.0)),
        ((0.5, 0.5, 0.5), (1.0, 0.2, 0.1)),
        ((0.7, 0.1, 1.5), (-0.2, 0.4, -1.0))]


def _same_hit(got, want):
    (gf, gh), (wf, wh) = got, want
    assert gf == wf
    if not wf:
        assert gh is None and wh is None
        return
    assert gh.t == pytest.approx(wh.t, rel=1e-6)
    assert (gh.u, gh.v) == pytest.approx((wh.u, wh.v), abs=1e-5)
    assert (gh.mesh_index, gh.triangle_index) == (wh.mesh_index,
                                                  wh.triangle_index)
    for a, b in zip(gh.vertex, wh.vertex):
        assert a.index == b.index
        np.testing.assert_array_equal(a.position, b.position)


@pytest.mark.parametrize("i", range(len(RAYS)))
def test_single_rays_match_rtk_tpu_compat(i):
    logs = []
    scene = compat.rtk_build_scene(compat.RtkSceneDesc(
        [_raw_mesh(MeshDesc)], log_fn=lambda u, b, s: logs.append(s)),
        device=CPU)
    assert logs
    jscene = jcompat.rtk_build_scene([_raw_mesh(JaxMeshDesc)])
    o, d = RAYS[i]
    ray, jray = compat.RtkRay(o, d), jcompat.RtkRay(o, d)
    nearest = jcompat.rtk_trace_ray(jscene, jray)
    _same_hit(compat.rtk_trace_ray(scene, ray), nearest)
    # Reject the triangle the unfiltered trace found (test_compat.py:58).
    tri = nearest[1].triangle_index if nearest[0] else -1

    def reject(user, r, c):
        assert user == "u" and r is not None
        return c.triangle_index != tri

    _same_hit(compat.rtk_trace_ray_filter(scene, ray, reject, "u"),
              jcompat.rtk_trace_ray_filter(jscene, jray, reject, "u"))


def _raising_mesh():
    def position_cb(user, indices):
        raise OSError("decode failed")

    return MeshDesc(num_triangles=4, position_cb=position_cb,
                    indices=np.arange(12, dtype=np.uint32))


@pytest.mark.parametrize("threads", [1, 4])
def test_a_raising_task_propagates(threads):
    """The reference's pool respawns workers forever once a task raises
    (ROADMAP §3); the port raises the task's exception.  Run under a
    timeout of its own so a hang fails the test instead of the run."""
    out = {}

    def run():
        try:
            tasks.build_scene_tasks([_meshes()[0], _raising_mesh()],
                                    num_threads=threads, device=CPU)
            out["result"] = "returned"
        except OSError as e:
            out["result"] = e

    th = threading.Thread(target=run, daemon=True)
    th.start()
    th.join(JOIN_TIMEOUT_S)
    assert not th.is_alive(), "build_scene_tasks hung on a raising task"
    assert isinstance(out["result"], OSError)
    assert "decode failed" in str(out["result"])


def test_many_meshes_on_more_threads_than_cores():
    """A stress run of the pool: 24 meshes, 16 threads, a short switch
    interval; the scene equals the one-thread build."""
    rng = np.random.default_rng(2)
    meshes = [_soup_of(rng.normal(size=(int(rng.integers(1, 40)), 3, 3))
                       .astype(np.float32)) for _ in range(24)]
    want = tasks.build_scene_tasks(meshes, device=CPU)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        got = tasks.build_scene_tasks(meshes, num_threads=16, device=CPU)
    finally:
        sys.setswitchinterval(old)
    _assert_scenes_equal(got, want)

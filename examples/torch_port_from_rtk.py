"""Porting an rtk C program 1:1 through rtk_tpu_torch's compat shim.

The migration starting point for a user of the reference library: every
call below is spelled like the rtk.h entry point it replaces
(rtk.h:119-130), including the cooperative multithreaded build (host-owned
worker threads pulling rtk_run_task from a shared queue, the reference's
intended usage) and single-ray queries.  Once running, batch the queries
(rtk_tpu_torch.Tracer over ray tensors) to get the card's throughput:
single-ray calls are dominated by launch latency by design.

    PYTHONPATH=. python examples/torch_port_from_rtk.py \
        [--threads 4] [--device cuda]
"""
import argparse
import queue as queue_mod
import threading

import numpy as np

from rtk_tpu_torch.compat import (RTK_TYPE_U16, RtkMesh, RtkRay,
                                  RtkSceneDesc, rtk_build_scene,
                                  rtk_finish_build, rtk_get_build_size,
                                  rtk_run_task, rtk_start_build,
                                  rtk_trace_ray, rtk_trace_ray_filter)
from rtk_tpu_torch.testing import scenes


def main(threads=4, device="cuda"):
    # --- describe meshes the rtk way: raw buffers + strides + types ---
    tris = scenes.cornell_box()  # (T, 3, 3) f32
    verts = tris.reshape(-1, 3).astype(np.float32)
    idx = np.arange(verts.shape[0], dtype=np.uint16)
    mesh = RtkMesh(
        num_triangles=tris.shape[0],
        positions=verts.tobytes(), position_stride=12,
        # stride is between consecutive INDICES (rtk.h:54-58), not triples
        indices=idx.tobytes(), index_stride=2, index_type=RTK_TYPE_U16,
    )
    desc = RtkSceneDesc(
        meshes=[mesh],
        log_fn=lambda user, build, msg: print(f"[build] {msg}"),
    )

    # --- multithreaded build: host owns the threads (rtk.h:108-115) ---
    build, first_tasks = rtk_start_build(desc, device=device)
    work = queue_mod.Queue()
    for t in first_tasks:
        work.put(t)
    pending = [len(first_tasks)]
    lock = threading.Lock()

    def worker():
        while True:
            try:
                task = work.get(timeout=0.05)
            except queue_mod.Empty:
                with lock:
                    if pending[0] == 0:
                        return
                continue
            n = 0
            try:
                spawned = []
                n = rtk_run_task(task, spawned)
                for s in spawned:
                    work.put(s)
            finally:
                # Decrement even if a task raises: a dead task must not
                # strand the other workers in the drain loop.
                with lock:
                    pending[0] += n - 1

    pool = [threading.Thread(target=worker) for _ in range(threads)]
    for t in pool:
        t.start()
    for t in pool:
        t.join()
    print(f"[build] serialized size: {rtk_get_build_size(build)} bytes")
    scene = rtk_finish_build(build)

    # --- single-ray queries, rtk_trace_ray spelling (rtk.h:129):
    # returns (hit_found, RtkHit) like the C bool + out-param pair ---
    ray = RtkRay(origin=(0.0, 0.0, 2.5), direction=(0.0, 0.0, -1.0))
    found, hit = rtk_trace_ray(scene, ray)
    assert found
    print(f"closest: t={hit.t:.4f} mesh={hit.mesh_index} "
          f"tri={hit.triangle_index} u={hit.u:.3f} v={hit.v:.3f}")
    print(f"vertex records: {[v.index for v in hit.vertex]}")

    # rtk_trace_ray_filter: a real filtered traversal (the reference stubs
    # this, rtk.c:579-582): reject the first-hit triangle, get the next.
    def reject_first(user, r, cand):
        return cand.triangle_index != hit.triangle_index

    found2, hit2 = rtk_trace_ray_filter(scene, ray, reject_first)
    assert found2 and hit2.t >= hit.t
    print(f"filtered: next surface at t={hit2.t:.4f} "
          f"tri={hit2.triangle_index}")

    # one-shot convenience build, same result
    scene2 = rtk_build_scene(desc, device=device)
    found3, hit3 = rtk_trace_ray(scene2, ray)
    assert found3 and abs(hit3.t - hit.t) < 1e-6
    print("one-shot build matches task build: port OK")
    return hit.t, hit2.t


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--threads", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    main(**vars(ap.parse_args()))

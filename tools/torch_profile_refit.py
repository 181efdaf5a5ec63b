"""Where a dynamic scene's frame spends its time on the card (BASELINE
config 4): refit, repack, trace and the fused frame, each alone, beside
the floor of one tiny op and a trace large enough to separate a call's
fixed cost from its per-ray cost.

    python3 tools/torch_profile_refit.py

The counterpart of tools/profile_refit.py for rtk_tpu_torch.  Run it from
the repository's root on a machine with one CUDA card; it needs only the
committed files (nvcc builds the kernel library into rtk_tpu_torch/build/
at first use) and takes well under a minute.

Scene: deforming_grid(0, n=96) (18,432 triangles), build_from_soup with
BuildConfig(branching=8, leaf_size=8), pack_scene; the frame moves it to
deforming_grid(0.2); rays: 256^2 Morton-ordered primaries from (0, 3, 4),
fov 50, and 1024^2 of the same camera for the large trace.  Stages:
refit alone (on the card csrc/refit.cu's launches), repack_bounds alone
(one launch), their plain versions (scene.refit_reference,
packed.repack_reference: the eager ops, on the card), trace_packets
alone (unsorted), the fused trace_packets_refit frame (unsorted), one
eager x + 1.0 on an (8, 128) f32 tensor, and the unsorted trace of the
1024^2 rays.  Each is timed by torch_profile_trace.py's timeit(): the
pipelined issue rate of back-to-back calls, not one call's latency.  It
prints ms a stage (and Mrays/s for the traces); then for the refit and
the repack: launches a call, ms at the issue rate beside the plain
version's, the card's ms a call alone (card_ms: calls queued behind a
spin, so the host's issue is hidden) and the bound of their bytes
(frame_bytes) at 3.35 TB/s; and the card's name and power limit.  Needs
a CUDA device; imports no jax.
"""
import os
import subprocess
import sys
import time

import torch

TOOLS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TOOLS)
if REPO not in sys.path:  # run as a script: the package is one level up
    sys.path.insert(0, REPO)
if TOOLS not in sys.path:  # loaded from its file: its sibling tools
    sys.path.append(TOOLS)

import rtk_tpu_torch as rt  # noqa: E402
from rtk_tpu_torch.ops.packet_trace import (trace_packets,  # noqa: E402
                                            trace_packets_refit)
from rtk_tpu_torch import scene as tscene  # noqa: E402
from rtk_tpu_torch.testing import scenes  # noqa: E402
from rtk_tpu_torch.trace import packed as tpacked  # noqa: E402
from rtk_tpu_torch.trace.packed import pack_scene, repack_bounds  # noqa: E402
from torch_profile_trace import timeit  # noqa: E402

CAM = dict(eye=(0, 3, 4), look_at=(0, 0, 0), up=(0, 1, 0), fov_deg=50)
GRID_N = 96
SIDE = 256
BIG_SIDE = 1024
FRAME_TIMES = (0.1, 0.2, 0.3)  # the frames made; the stages move to the 2nd
ITERS = {"tiny_op": 20, "trace_big": 5}  # profile_refit.py's; others 10
HBM_BYTES_S = 3.35e12  # the H100 SXM's device memory, bytes a second
SPIN_CYCLES = 200_000_000  # card_ms's spin: about 0.1 s at 1.98 GHz


def stages(device, n=GRID_N, side=SIDE, big_side=BIG_SIDE):
    """The frame's stages on `device` -> ({name: callable}, {name: rays a
    call traces}): "refit" (returns the refit Scene), "repack" (the
    repacked tables of that Scene), "trace" (PacketHits of the repacked
    tables), "fused" (trace_packets_refit's (hits, scene, packed)),
    "tiny_op" and "trace_big" (PacketHits of big_side^2 rays)."""
    cfg = rt.BuildConfig(branching=8, leaf_size=8)
    scene = rt.build_from_soup(scenes.deforming_grid(0.0, n=n), config=cfg,
                               device=device)
    packed = pack_scene(scene)
    frames = [torch.as_tensor(scenes.deforming_grid(t, n=n), device=device)
              for t in FRAME_TIMES]
    cam, cam_big = (scenes.camera_rays(**CAM, width=s, height=s,
                                       order="morton", device=device)
                    for s in (side, big_side))
    scene2 = rt.refit(scene, frames[1])
    packed2 = repack_bounds(packed, scene2)
    x = torch.zeros((8, 128), dtype=torch.float32, device=device)
    fns = {
        "refit": lambda: rt.refit(scene, frames[1]),
        "repack": lambda: repack_bounds(packed, scene2),
        "refit_plain": lambda: tscene.refit_reference(scene, frames[1]),
        "repack_plain": lambda: tpacked.repack_reference(packed, scene2),
        "trace": lambda: trace_packets(packed2, cam, sort_rays=False),
        "fused": lambda: trace_packets_refit(packed, scene, frames[1], cam,
                                             sort_rays=False),
        "tiny_op": lambda: x + 1.0,
        "trace_big": lambda: trace_packets(packed2, cam_big,
                                           sort_rays=False)}
    rays = {"trace": cam.count, "fused": cam.count,
            "trace_big": cam_big.count}
    return fns, rays


def frame_bytes(scene, packed) -> dict:
    """The bytes a frame's refit and repack must move at the least: the
    refit reads the soup and writes the sorted vertices, the leaf and node
    boxes, the bounds (and the wide slots' boxes where the Scene has
    them); the repack reads the sorted vertices and writes the packed
    vertices, the triangle table and the node rows."""
    tp = scene.tri_v.shape[0]
    boxes = (scene.leaf_min.shape[0] + scene.bin_min.shape[0] + 1) * 24
    wide = scene.node_min.numel() * 8 if scene.has_wide else 0
    return {"refit": scene.num_tris * 36 + tp * 36 + boxes + wide,
            "repack": tp * 36 + tp * (36 + 64) + packed.nodes.numel() * 4}


def card_ms(fn, reps=50):
    """The card's ms a call of fn at its own pace: `reps` back-to-back
    calls queued behind a spin on the card (torch.cuda._sleep), CUDA
    events around them, so the host's issue time is hidden.  Raises if
    the host took longer to issue them than the spin lasted."""
    fn()
    torch.cuda.synchronize()
    e0, e1, e2 = (torch.cuda.Event(enable_timing=True) for _ in range(3))
    e0.record()
    torch.cuda._sleep(SPIN_CYCLES)
    e1.record()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    issue_ms = (time.perf_counter() - t0) * 1e3
    e2.record()
    torch.cuda.synchronize()
    if issue_ms >= e0.elapsed_time(e1):
        raise RuntimeError(f"card_ms: the host took {issue_ms:.3f} ms to "
                           f"issue {reps} calls, longer than the spin")
    return e1.elapsed_time(e2) / reps


def refit_rows(fns, scene, packed, reps=20) -> dict:
    """For the refit and the repack: launches a call (the kernels'
    counters), the kernels' ms a call at the issue rate (timeit) and the
    card's ms a call alone (card_ms over reps calls), the plain version's
    ms a call at the issue rate (its launches, a hundred-odd a refit,
    cannot all be queued behind a spin: the host then waits for the
    card), the bound of frame_bytes at HBM_BYTES_S and card ms over
    bound."""
    bytes_ = frame_bytes(scene, packed)
    rows = {}
    for name, counter in (("refit", (tscene, "REFIT_LAUNCHES")),
                          ("repack", (tpacked, "REPACK_LAUNCHES"))):
        before = getattr(*counter)
        fns[name]()
        launches = getattr(*counter) - before
        ms = card_ms(fns[name], reps)
        bound_ms = bytes_[name] / HBM_BYTES_S * 1e3
        rows[name] = {"launches": launches,
                      "issue_ms": timeit(fns[name], iters=10) * 1e3,
                      "card_ms": ms,
                      "plain_ms": timeit(fns[f"{name}_plain"],
                                         iters=10) * 1e3,
                      "bytes": bytes_[name], "bound_ms": bound_ms,
                      "over_bound": ms / bound_ms}
    return rows


def main():
    if not torch.cuda.is_available():
        raise SystemExit("torch_profile_refit.py needs a CUDA device")
    print(f"device: {torch.cuda.get_device_name(0)}", flush=True)
    fns, rays = stages(torch.device("cuda"))
    for name, fn in fns.items():
        dt = timeit(fn, iters=ITERS.get(name, 10))
        rate = (f" -> {rays[name] / dt / 1e6:.2f} Mrays/s" if name in rays
                else "")
        print(f"{name + ':':14s}{dt * 1e3:8.3f} ms{rate}", flush=True)
    scene = fns["refit"]()
    for name, row in refit_rows(fns, scene, fns["repack"]()).items():
        print(f"{name}: {row['launches']} launches, {row['issue_ms']:.4f} "
              f"ms (plain {row['plain_ms']:.4f}); card alone "
              f"{row['card_ms']:.4f} ms, {row['bytes']} B, bound "
              f"{row['bound_ms']:.4f} ms ({row['over_bound']:.1f}x)",
              flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())

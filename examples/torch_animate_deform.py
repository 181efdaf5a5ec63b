"""Deforming-scene demo on rtk_tpu_torch: one LBVH topology, a refit on
the device every frame, and the clip front-end that traces many frames
with one coherence sort of the rays.

The reference library rebuilds from scratch for dynamic scenes (rtk has no
refit); here the topology is kept and the bounds and kernel tables are
refit on the device (`trace_packets_refit`), and a clip of frames shares
the ray sort (`trace_packets_refit_frames`).

    PYTHONPATH=. python examples/torch_animate_deform.py \
        [--frames 8] [--size 128] [--grid 64] [--device cuda]
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

import rtk_tpu_torch as rt
from rtk_tpu_torch.ops.packet_trace import (trace_packets_refit,
                                            trace_packets_refit_frames)
from rtk_tpu_torch.testing import scenes
from rtk_tpu_torch.trace.packed import pack_scene


def main(frames=8, size=128, grid=64, device="cuda"):
    sync = (torch.cuda.synchronize if torch.device(device).type == "cuda"
            else lambda: None)
    frame = lambda i: torch.as_tensor(  # noqa: E731
        scenes.deforming_grid(0.05 * i, n=grid), device=device)
    grid0 = scenes.deforming_grid(0.0, n=grid)
    scene = rt.build_scene(
        (grid0.reshape(-1, 3), np.arange(grid0.shape[0] * 3).reshape(-1, 3)),
        device=device)
    packed = pack_scene(scene)
    cam = scenes.camera_rays((0, 3, 4), (0, 0, 0), (0, 1, 0), 50, size, size,
                             order="morton", device=device)

    # Per frame: refit, regather the tables, trace.
    clip = torch.stack([frame(i) for i in range(frames)])
    trace_packets_refit(packed, scene, clip[0], cam)  # builds the kernel
    sync()
    t0 = time.perf_counter()
    for pos in clip:
        hits, _, _ = trace_packets_refit(packed, scene, pos, cam)
    sync()
    per_frame = (time.perf_counter() - t0) / frames
    print(f"per-frame refit+trace: {per_frame*1e3:.1f} ms/frame")

    # The whole clip through one call.
    t0 = time.perf_counter()
    out = trace_packets_refit_frames(packed, scene, clip, cam)
    sync()
    per_frame = (time.perf_counter() - t0) / frames
    print(f"{frames}-frame clip: {per_frame*1e3:.1f} ms/frame")
    rates = [float(h.hit.float().mean()) for h in out]
    for i, r in enumerate(rates):
        print(f"  frame {i}: hit rate {r:.3f}")
    assert torch.equal(out[-1].hit, hits.hit)
    return rates


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--size", type=int, default=128)
    ap.add_argument("--grid", type=int, default=64)
    ap.add_argument("--device", default="cuda")
    main(**vars(ap.parse_args()))

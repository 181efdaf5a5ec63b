"""Serving with no build at start-up: a scene blob and a trace artifact.

The reference's deployment story is "the blob is the runtime format": map
the scene and call rtk_trace_ray (rtk.h:78-89).  On the card the costly
start-up step is building the kernel, so a server takes TWO artifacts:

  1. the packed-scene blob   (utils/serialize.save_packed_scene)
  2. the trace artifact      (utils/aot.export_packet_trace), which
     carries the compiled kernel library

This example builds and exports in one process (the deploy step), then
runs itself again as a fresh server process that only reads the two files
and traces: it loads the embedded library and never calls nvcc.  The
files go to a new temporary directory.  From a repo checkout:

    PYTHONPATH=. python examples/torch_serve_aot.py [--size 64] \
        [--device cuda]
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile
import time

import torch

import rtk_tpu_torch as rt
from rtk_tpu_torch.ops import packet_trace
from rtk_tpu_torch.testing import scenes
from rtk_tpu_torch.trace.packed import pack_scene
from rtk_tpu_torch.utils.aot import export_packet_trace, load_packet_trace
from rtk_tpu_torch.utils.serialize import load_packed_scene, save_packed_scene

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def export(out_dir, size, device):
    """Build once and write both artifacts (the deploy step)."""
    packed = pack_scene(rt.build_from_soup(
        scenes.cornell_box(), config=rt.BuildConfig(branching=8,
                                                    leaf_size=8),
        device=device))
    save_packed_scene(packed, os.path.join(out_dir, "scene.rtk"))
    blob = export_packet_trace(packed, size * size)
    with open(os.path.join(out_dir, "trace.aot"), "wb") as f:
        f.write(blob)
    print(f"[export] wrote scene.rtk + trace.aot ({len(blob)} B) to "
          f"{out_dir}")


def serve(out_dir, size, device):
    """A fresh process: two file reads, no build."""
    sync = (torch.cuda.synchronize if torch.device(device).type == "cuda"
            else lambda: None)
    t0 = time.perf_counter()
    packed = load_packed_scene(os.path.join(out_dir, "scene.rtk"),
                               device=device)
    with open(os.path.join(out_dir, "trace.aot"), "rb") as f:
        trace = load_packet_trace(f.read())
    rays = scenes.cornell_camera(size, size, device=device)
    hits = trace(packed, rays)
    sync()
    rate = float(hits.hit.float().mean())
    print(f"[serve] load + first trace: {time.perf_counter() - t0:.2f} s, "
          f"hit rate {rate:.2f}, kernel builds in this process: "
          f"{len(packet_trace.BUILD_SECONDS)}")
    t0 = time.perf_counter()
    hits = trace(packed, rays)
    sync()
    print(f"[serve] steady state: {(time.perf_counter() - t0) * 1e3:.2f} ms "
          f"for {rays.count} rays")
    return rate


def main(size=64, device="cuda"):
    with tempfile.TemporaryDirectory() as out_dir:
        export(out_dir, size, device)
        subprocess.run([sys.executable, os.path.abspath(__file__), "--serve",
                        out_dir, "--size", str(size), "--device", device],
                       check=True, env={**os.environ, "PYTHONPATH": REPO})


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--size", type=int, default=64)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--serve", metavar="DIR",
                    help="run as the server on DIR's two files")
    args = ap.parse_args()
    if args.serve:
        serve(args.serve, args.size, args.device)
    else:
        main(args.size, args.device)

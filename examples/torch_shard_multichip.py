"""Sharding demo on rtk_tpu_torch: every mode over a mesh of torch devices.

  1. ray sharding   - scene copied to each device, rays split
  2. scene sharding - one spatial part per device, nearest-hit combine
  3. hybrid 2-D     - scene parts x ray shards on one 2-axis mesh

With several cards the mesh is every card.  With one card the mesh names
that card 8 times, and the demo says so: every shard's launches and the
combine run on that card, which checks the modes but measures what
splitting costs, not how it scales.  `--device cpu` runs on 8 CPU entries
(the kernel's plain version).  From a repo checkout:

    PYTHONPATH=. python examples/torch_shard_multichip.py \
        [--size 64] [--device cuda]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

import rtk_tpu_torch as rt
from rtk_tpu_torch.parallel.shard import (build_scene_sharded, default_mesh,
                                          hybrid_mesh,
                                          trace_closest_scene_sharded,
                                          trace_packets_sharded)
from rtk_tpu_torch.testing import scenes
from rtk_tpu_torch.trace.packed import pack_scene


def mesh_devices(device: str) -> list:
    """Every card, or one card (or the CPU) named 8 times."""
    if torch.device(device).type == "cpu":
        print("mesh: 8 entries on the CPU (the kernel's plain version)")
        return [torch.device("cpu")] * 8
    n = torch.cuda.device_count()
    if n == 0:
        raise SystemExit("no CUDA device is visible; run with --device cpu")
    if n > 1:
        print(f"mesh: {n} cards")
        return [torch.device("cuda", i) for i in range(n)]
    print(f"mesh: one card ({torch.cuda.get_device_name(0)}) named 8 times: "
          "the modes run on it; their times are not a scaling result")
    return [torch.device("cuda", 0)] * 8


def main(size=64, device="cuda"):
    devices = mesh_devices(device)
    cfg = rt.BuildConfig(branching=8, leaf_size=8)
    tris = scenes.blob(subdivisions=4)[0]  # 5,120 tris
    desc = (tris.reshape(-1, 3), np.arange(tris.shape[0] * 3).reshape(-1, 3))
    rays = scenes.camera_rays((0, 0, 3.0), (0, 0, 0), (0, 1, 0), 45, size,
                              size, device=devices[0])

    # one device, unsharded
    scene = rt.build_scene(desc, cfg, device=devices[0])
    want = rt.Tracer(scene).closest(rays)
    print(f"one device: {int(want.hit.sum())}/{rays.count} hits")

    # 1. ray sharding: the packet trace on each shard, tables copied
    mesh = default_mesh(devices)
    h1 = trace_packets_sharded(pack_scene(scene), rays, mesh)
    assert torch.equal(h1.hit, want.hit) and torch.equal(h1.t, want.t)
    print(f"ray-sharded over {mesh.size} entries: match")

    # 2. scene sharding: one spatial part per entry, hits combined
    sscene = build_scene_sharded(desc, mesh, cfg)
    h2 = trace_closest_scene_sharded(sscene, rays, mesh)
    assert torch.equal(h2.hit, want.hit)
    print(f"scene-sharded into {sscene.num_parts} parts: match")

    # 3. hybrid 2-D: scene rows x ray columns on a ("scene", "rays") mesh
    m2 = hybrid_mesh(n_scene=2, devices=devices)
    ss2 = build_scene_sharded(desc, m2, cfg)
    h3 = trace_closest_scene_sharded(ss2, rays, m2)
    assert torch.equal(h3.hit, want.hit)
    print(f"hybrid 2-D ({m2.shape['scene']} scene rows x "
          f"{m2.shape['rays']} ray columns): match")
    return int(want.hit.sum())


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--size", type=int, default=64)
    ap.add_argument("--device", default="cuda")
    main(**vars(ap.parse_args()))

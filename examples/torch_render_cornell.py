"""End-to-end demo on rtk_tpu_torch: path-trace the Cornell box and write
a PPM image.

Runs on the card by default (the CUDA traversal kernel, built with nvcc at
first use); `--device cpu` runs the kernel's plain PyTorch version.  From a
repo checkout:

    PYTHONPATH=. python examples/torch_render_cornell.py [out.ppm] \
        [--size 256] [--spp 4] [--device cuda]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

import rtk_tpu_torch as rt
from rtk_tpu_torch.models.path import Materials, render_path
from rtk_tpu_torch.testing import scenes


def main(out="cornell.ppm", size=256, spp=4, device="cuda"):
    tris = scenes.cornell_box()
    scene = rt.build_scene(
        (tris.reshape(-1, 3), np.arange(tris.shape[0] * 3).reshape(-1, 3)),
        device=device)
    tracer = rt.Tracer(scene)

    # cornell_box() is one mesh; shade it with a neutral albedo and light
    # it with a constant background seen through the open front.
    mats = Materials.make(albedo=[[0.73, 0.73, 0.73]], device=device)

    rays = scenes.cornell_camera(size, size, device=device)
    acc = torch.zeros((size * size, 3), device=device)
    gen = torch.Generator(device=device).manual_seed(7)
    for _ in range(spp):
        acc += render_path(tracer, rays, mats, gen, bounces=3,
                           background=(3.0, 3.0, 3.0))
    acc = (acc / spp).cpu().numpy()

    # simple tonemap + gamma
    rgb = np.clip(acc / (1.0 + acc), 0.0, 1.0) ** (1.0 / 2.2)
    px = (rgb.reshape(size, size, 3) * 255).astype(np.uint8)
    with open(out, "wb") as f:
        f.write(f"P6\n{size} {size}\n255\n".encode())
        f.write(px.tobytes())
    print(f"wrote {out}: {size}x{size}, {spp} spp, "
          f"mean luminance {rgb.mean():.3f}")
    return rgb


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("out", nargs="?", default="cornell.ppm")
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--spp", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    main(**vars(ap.parse_args()))

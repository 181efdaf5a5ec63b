"""Query kind "path": one frame of the wavefront path tracer, timed and
checked.

The configuration's `query` states it: kind "path", bounces, compact,
sort_rays, epsilon, background, and the materials as consecutive ranges
of the soup's rows ({name, rows, albedo, emission}), whose rows sum to the
scene's triangles.  `Program` is the system under test: the scene built by
the program as one mesh a material range, its Tracer and Materials, and
one timed call, render_path over a batch with the batch's uniforms handed
in (uniforms[k, i]: bounce k of the path that starts as ray i), returning
the (N, 3) radiance.  Because the uniforms go by ray, a path's radiance
does not depend on compaction, buckets or the sort, so `check` traces only
a seeded sample of the paths of each kept call, with the plain path
tracer (rtbench/path_reference.py), which takes nothing from the program.
"""
from __future__ import annotations

import json

import numpy as np
import torch

from rtbench import path_reference
from rtbench.traffic import generate

CHECKS = ("radiance_bad_share", "radiance_mean_gap")
CHECK_RAYS = 100  # the seed's streams of the paths checked of each call
TOL = 1e-4  # a path agrees within TOL * max(1, |L_ref|) in each channel
# Counters of one warm call, in models/path.py and ops/packet_trace.py.
PATH_COUNTERS = ("PATH_TRACES", "PATH_ROWS", "PATH_SYNCS")
LAUNCH_COUNTERS = ("KERNEL_LAUNCHES", "KEY_LAUNCHES", "ROWS_LAUNCHES",
                   "UNSORT_LAUNCHES")


def settings(q) -> dict:
    """render_path's keywords of the query."""
    return dict(bounces=int(q["bounces"]), compact=bool(q["compact"]),
                sort_rays=bool(q["sort_rays"]), epsilon=float(q["epsilon"]),
                background=tuple(float(x) for x in q["background"]))


class Program:
    """The system under test: the configuration's scene built by the
    program on `device`, one mesh a material range, and one timed call."""

    def __init__(self, cell, positions, indices, device):
        import rtk_tpu_torch as rt
        from rtk_tpu_torch.models import path

        q = cell["config"]["query"]
        b = cell["config"]["build"]
        if b["builder"] != "lbvh":
            raise ValueError(f"unknown builder {b['builder']!r}")
        rows = [int(m["rows"]) for m in q["materials"]]
        if sum(rows) != len(indices):
            raise ValueError(f"the materials' rows sum to {sum(rows)}, the "
                             f"scene has {len(indices)} triangles")
        soup = np.asarray(positions, np.float32)[np.asarray(indices)]
        cuts = np.cumsum([0] + rows)
        meshes = [(soup[a:z].reshape(-1, 3),
                   np.arange(3 * (z - a)).reshape(-1, 3))
                  for a, z in zip(cuts[:-1], cuts[1:])]
        self.rt, self.path, self.device = rt, path, device
        self.scene = rt.build_scene(
            meshes, rt.BuildConfig(leaf_size=b["leaf_size"],
                                   branching=b["width"],
                                   morton_bits=b["morton_bits"]),
            device=device)
        self.tracer = rt.Tracer(self.scene)
        self.tracer.packed
        self.materials = path.Materials.make(
            [m["albedo"] for m in q["materials"]],
            [m["emission"] for m in q["materials"]], device=device)
        self.kw = settings(q)
        self.first = None

    def notes(self, n) -> list:
        """Earlier lines of a run: the counters of one warm call on the
        first batch, the render loop's beside the front end's launches."""
        from rtk_tpu_torch.ops import packet_trace

        mods = [(self.path, PATH_COUNTERS), (packet_trace, LAUNCH_COUNTERS)]
        before = {c: getattr(m, c) for m, cs in mods for c in cs}
        self(self.first)
        if torch.device(self.device).type == "cuda":
            torch.cuda.synchronize()
        got = {c: getattr(m, c) - before[c] for m, cs in mods for c in cs}
        return [f"one warm call of {n} paths: {json.dumps(got)}"]

    def rays(self, batch):
        x = (self.rt.Rays(origin=batch["origin"],
                          direction=batch["direction"],
                          min_t=batch["min_t"], max_t=batch["max_t"]),
             batch["uniforms"])
        self.first = self.first or x
        return x

    def __call__(self, x) -> torch.Tensor:
        rays, uniforms = x
        return self.path.render_path(self.tracer, rays, self.materials,
                                     uniforms=uniforms, **self.kw)


def check(cell, kept, batches, soup, seed, dtype=None):
    """Hold a seeded sample of the paths of each kept call to the plain
    path tracer -> over all the sampled paths:
      radiance_bad_share: the share whose radiance differs from the
        reference's in some channel by more than TOL * max(1, |L_ref|)
        (or is not a number);
      radiance_mean_gap: |mean L - mean L_ref| / mean L_ref, a bias that
        the per-path tolerance lets through;
    and, for the limits' calibration, the sample's mean and largest
    reference radiance.  dtype: judge the reference computed in that
    precision in the program's place (the control) instead."""
    q = cell["config"]["query"]
    kw = {k: v for k, v in settings(q).items()
          if k not in ("compact", "sort_rays")}
    material = path_reference.material_of_rows(
        [int(m["rows"]) for m in q["materials"]], soup.device)
    albedo = [m["albedo"] for m in q["materials"]]
    emission = [m["emission"] for m in q["materials"]]
    m = int(cell["traffic"]["check"]["rays"])
    bad = n_all = 0
    got_sum = want_sum = want_max = 0.0
    for j, (b, rec) in enumerate(kept):
        x = batches[b]
        n = x["origin"].shape[0]
        host = generate.rng(seed, CHECK_RAYS + j)
        pick = torch.as_tensor(np.sort(host.choice(n, min(m, n),
                                                   replace=False)),
                               device=soup.device)
        args = [x[k][pick] for k in ("origin", "direction", "min_t",
                                     "max_t")]
        args.append(x["uniforms"][:, pick])
        want = path_reference.render(soup, material, albedo, emission,
                                     *args, **kw)
        if dtype is None:
            got = rec[pick].float()
        else:
            got = path_reference.render(soup, material, albedo, emission,
                                        *args, **kw, dtype=dtype)
        ok = ((got - want).abs() <= TOL * want.abs().clamp_min(1.0))
        bad += int((~ok.all(dim=1)).sum())
        n_all += pick.numel()
        got_sum += float(got.double().sum())
        want_sum += float(want.double().sum())
        want_max = max(want_max, float(want.max()))
    return {
        "radiance_bad_share": bad / max(n_all, 1),
        "radiance_mean_gap": abs(got_sum - want_sum) / max(want_sum, 1e-30),
        "radiance_mean_ref": want_sum / max(3 * n_all, 1),
        "radiance_max_ref": want_max,
    }

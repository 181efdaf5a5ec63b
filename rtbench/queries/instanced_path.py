"""Query kind "instanced_path": one frame of the wavefront path tracer over
an instanced scene, timed and checked.

The configuration's `query` states it: kind "instanced_path",
max_candidates, bounces, compact, sort_rays, epsilon, background and one
material (albedo, emission) for every triangle of the BLAS.  Its `build`
states the tables: builder "sah_forest" (the host SAH forest over the
BLAS, width, leaf_size, step_quant) and `blas`, the BLAS Scene's own
LBVH (width, leaf_size) that the instance boxes and the exactness
residual read.  The scene generator gives the BLAS and the affines
(`instances`) besides the world soup (`make`).  `Program` is the system
under test: build_instanced over the BLAS, pack_instanced with the SAH
forest, the InstancedTracer, and one timed call, render_path over a batch
with the batch's uniforms handed in (uniforms[k, i]: bounce k of the path
that starts as ray i), returning the (N, 3) radiance.  `check` traces a
seeded sample of the paths of each kept call with the plain instanced
path tracer (rtbench/instanced_path_reference.py), which takes nothing
from the program.
"""
from __future__ import annotations

import json

import numpy as np
import torch

from rtbench import instanced_path_reference
from rtbench.loader import load_module
from rtbench.traffic import generate

CHECKS = ("radiance_bad_share", "radiance_mean_gap")
CHECK_RAYS = 100  # the seed's streams of the paths checked of each call
TOL = 1e-4  # a path agrees within TOL * max(1, |L_ref|) in each channel
# Counters of one warm call, by the program's module.
COUNTERS = {
    "instancing": ("INSTANCED_TRACES", "INSTANCED_ROUNDS", "INSTANCED_ROWS",
                   "INSTANCED_SYNCS", "INSTANCED_RESIDUAL"),
    "models.path": ("PATH_TRACES", "PATH_ROWS", "PATH_SYNCS",
                    "SHADE_LAUNCHES"),
    "ops.packet_trace": ("KERNEL_LAUNCHES", "ROOTS_LAUNCHES"),
}


def settings(q) -> dict:
    """render_path's keywords of the query."""
    return dict(bounces=int(q["bounces"]), compact=bool(q["compact"]),
                sort_rays=bool(q["sort_rays"]), epsilon=float(q["epsilon"]),
                background=tuple(float(x) for x in q["background"]))


def instances_of(cell):
    """The generator's BLAS and affines -> (positions, indices,
    transforms)."""
    sc = cell["config"]["scene"]
    gen = load_module(cell["root"] / "rtbench" / "scenes" /
                      f"{sc['generator']}.py")
    return gen.instances(**sc.get("args", {}))


def material(q):
    """The query's one material -> (albedo, emission)."""
    (m,) = q["materials"]
    return m["albedo"], m["emission"]


class Program:
    """The system under test: the configuration's instanced scene built
    by the program on `device`, its InstancedTracer, and one timed call."""

    def __init__(self, cell, positions, indices, device):
        import importlib

        import rtk_tpu_torch as rt
        from rtk_tpu_torch.builder.sah import build_sah_forest
        from rtk_tpu_torch.instancing import InstancedTracer
        from rtk_tpu_torch.models import path

        q = cell["config"]["query"]
        b = cell["config"]["build"]
        if b["builder"] != "sah_forest" or b["blas"]["builder"] != "lbvh":
            raise ValueError(f"unknown builders {b['builder']!r}, "
                             f"{b['blas']['builder']!r}")
        bpos, bidx, tf = instances_of(cell)
        soup = np.asarray(bpos, np.float32)[np.asarray(bidx)]
        blas = rt.build_from_soup(
            soup, config=rt.BuildConfig(branching=b["blas"]["width"],
                                        leaf_size=b["blas"]["leaf_size"]),
            device=device)
        iscene = rt.build_instanced([blas], np.zeros(len(tf), np.int64), tf)
        packed, roots = build_sah_forest(
            [soup], rt.BuildConfig(branching=b["width"],
                                   leaf_size=b["leaf_size"]),
            step_quant=bool(b["step_quant"]), device=device)
        self.pscene = rt.pack_instanced(iscene, packed=packed,
                                        packed_roots=roots)
        self.tracer = InstancedTracer(self.pscene,
                                      max_candidates=q["max_candidates"])
        albedo, emission = material(q)
        self.rt, self.path, self.device = rt, path, device
        self.modules = {m: importlib.import_module(f"rtk_tpu_torch.{m}")
                        for m in COUNTERS}
        self.materials = path.Materials.make([albedo], [emission],
                                             device=device)
        self.kw = settings(q)
        self.first = None

    def notes(self, n) -> list:
        """Earlier lines of a run: the counters of one warm call on the
        first batch, the instanced trace's and the render loop's beside
        the kernel's launches."""
        def read():
            return {c: getattr(self.modules[m], c)
                    for m, cs in COUNTERS.items() for c in cs}

        before = read()
        self(self.first)
        if torch.device(self.device).type == "cuda":
            torch.cuda.synchronize()
        got = {c: v - before[c] for c, v in read().items()}
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
    instanced path tracer -> over all the sampled paths:
      radiance_bad_share: the share whose radiance differs from the
        reference's in some channel by more than TOL * max(1, |L_ref|)
        (or is not a number);
      radiance_mean_gap: |mean L - mean L_ref| / mean L_ref, a bias that
        the per-path tolerance lets through;
    and, for the limits' calibration, the sample's mean and largest
    reference radiance.  soup (the world soup) is not read: the reference
    takes the generator's BLAS and affines.  dtype: judge the reference
    computed in that precision in the program's place (the control)
    instead."""
    q = cell["config"]["query"]
    kw = {k: v for k, v in settings(q).items()
          if k not in ("compact", "sort_rays")}
    dev = batches[0]["origin"].device
    bpos, bidx, tf = instances_of(cell)
    blas = torch.as_tensor(np.asarray(bpos, np.float32)[np.asarray(bidx)],
                           device=dev)
    albedo, emission = material(q)
    m = int(cell["traffic"]["check"]["rays"])
    bad = n_all = 0
    got_sum = want_sum = want_max = 0.0
    for j, (b, rec) in enumerate(kept):
        x = batches[b]
        n = x["origin"].shape[0]
        host = generate.rng(seed, CHECK_RAYS + j)
        pick = torch.as_tensor(np.sort(host.choice(n, min(m, n),
                                                   replace=False)),
                               device=dev)
        args = [x[k][pick] for k in ("origin", "direction", "min_t",
                                     "max_t")]
        args.append(x["uniforms"][:, pick])
        want = instanced_path_reference.render(blas, tf, albedo, emission,
                                               *args, **kw)
        if dtype is None:
            got = rec[pick].float()
        else:
            got = instanced_path_reference.render(blas, tf, albedo, emission,
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

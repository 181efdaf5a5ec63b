"""Query kind "refit": one frame of a deforming mesh, refit, repacked and
traced, timed and checked.

The configuration's `query` states it: kind "refit", the closest-hit
query of the kind "closest" (the watertight test in float32 and its
record), and the clip: `frames` frames of the scene generator's `frame`
at t = dt * k.  `Program` is the system under test: the rest pose built
by the program (the configuration's build, `wide_nodes` among it), its
Tracer with the packed tables, the clip's frames put on the device at
set-up (the user's animation, handed in, not timed), and one timed call:
the next frame of the clip (frame i mod frames on call i), `refit` of the
last frame's scene to it, `Tracer.refresh`, `Tracer.closest` and the
record's six fields, then the frame's index.  `check` makes each kept
call's frame again with the generator and holds its records to the plain
reference on that frame's soup, with the closest kind's three numbers.
"""
from __future__ import annotations

import json

import numpy as np
import torch

from rtbench import reference
from rtbench.loader import load_module
from rtbench.queries import closest
from rtbench.traffic import generate

CHECKS = closest.CHECKS
CHECK_RAYS = closest.CHECK_RAYS
# Counters of one warm call (a calls' difference), by module of the
# program; REFIT_LEVELS is a level count, read as it stands after the
# call.  A program without one reads null.
COUNTERS = (("rtk_tpu_torch.scene", ("REFITS",)),
            ("rtk_tpu_torch.trace.packed", ("REPACKS",)),
            ("rtk_tpu_torch.ops.packet_trace",
             ("KERNEL_LAUNCHES", "KEY_LAUNCHES", "ROWS_LAUNCHES",
              "UNSORT_LAUNCHES")))
LEVELS = ("rtk_tpu_torch.builder.lbvh", "REFIT_LEVELS")


def generator(cell):
    """The configuration's scene generator (its `frame` makes the clip)."""
    name = cell["config"]["scene"]["generator"]
    return load_module(cell["root"] / "rtbench" / "scenes" / f"{name}.py")


def clip_times(q) -> list:
    """The clip's times, t = dt * k for k < frames."""
    c = q["clip"]
    return [float(c["dt"]) * k for k in range(int(c["frames"]))]


class Program(closest.Program):
    """The system under test: the rest pose built by the program on
    `device`, the clip on the device, and one timed call."""

    def __init__(self, cell, positions, indices, device):
        import rtk_tpu_torch as rt

        q = cell["config"]["query"]
        if (q["test"], q["precision"], q["record"]) != (
                "watertight", "float32", closest.RECORD):
            raise ValueError(f"query {q!r}: this kind runs the watertight "
                             f"closest-hit test in float32 with the record "
                             f"{closest.RECORD}")
        b = cell["config"]["build"]
        if b["builder"] != "lbvh":
            raise ValueError(f"unknown builder {b['builder']!r}")
        self.rt = rt
        self.scene = rt.build_scene(
            (positions, indices),
            rt.BuildConfig(leaf_size=b["leaf_size"], branching=b["width"],
                           morton_bits=b["morton_bits"],
                           wide_nodes=bool(b.get("wide_nodes", True))),
            device=device)
        self.tracer = rt.Tracer(self.scene)
        self.tracer.packed
        rest = np.asarray(positions, np.float32)[np.asarray(indices)]
        frame = generator(cell).frame
        self.frames = torch.stack([torch.as_tensor(frame(rest, t))
                                   for t in clip_times(q)]).to(device)
        self.device = device
        self.calls = 0
        self.first = None

    def notes(self, n) -> list:
        """Earlier lines of a run: closest's, then the counters of one
        warm call on the first batch."""
        import importlib

        mods = [(importlib.import_module(m), cs) for m, cs in COUNTERS]
        before = {c: getattr(m, c, None) for m, cs in mods for c in cs}
        self(self.first)
        if torch.device(self.device).type == "cuda":
            torch.cuda.synchronize()
        got = {c: (None if before[c] is None else getattr(m, c) - before[c])
               for m, cs in mods for c in cs}
        got[LEVELS[1]] = getattr(importlib.import_module(LEVELS[0]),
                                 LEVELS[1], None)
        return super().notes(n) + [
            f"one warm call of {n} rays: {json.dumps(got)}"]

    def rays(self, batch):
        r = super().rays(batch)
        if self.first is None:
            self.first = r
        return r

    def __call__(self, rays) -> tuple:
        i = self.calls % self.frames.shape[0]
        self.calls += 1
        self.scene = self.rt.refit(self.scene, self.frames[i])
        self.tracer = self.tracer.refresh(self.scene)
        return closest.records(self.tracer.closest(rays)) + (i,)


def check(cell, kept, batches, soup, seed, dtype=None):
    """Hold each kept call's records on a seeded sample of its rays to the
    reference on its frame's soup -> closest.compare's numbers over all
    kept calls (the share over all sampled rays, the gaps the widest).
    soup: the rest pose's; dtype: judge the reference computed in that
    precision in the program's place (the control) instead."""
    frame = generator(cell).frame
    times = clip_times(cell["config"]["query"])
    rest = soup.cpu().numpy()
    m = int(cell["traffic"]["check"]["rays"])
    totals = {k: 0.0 for k in CHECKS}
    n_all = 0
    for j, (b, rec) in enumerate(kept):
        *rec, i = rec
        tris = torch.as_tensor(frame(rest, times[i]), device=soup.device)
        x = batches[b]
        n = x["origin"].shape[0]
        host = generate.rng(seed, CHECK_RAYS + j)
        pick = torch.as_tensor(np.sort(host.choice(n, min(m, n),
                                                   replace=False)),
                               device=soup.device)
        ray = [x[k][pick] for k in ("origin", "direction", "min_t", "max_t")]
        want = reference.closest(tris, *ray)
        if dtype is None:
            hit, t, u, v, tri, mesh = (r[pick] for r in rec)
            # The scene is one mesh: triangle k of mesh 0 is soup row k.
            ok = (mesh == 0) & (tri >= 0) & (tri < tris.shape[0])
            idx = torch.where(ok, tri.long(), -1)
            miss_ok = ((t == ray[3]) & (u == 0) & (v == 0) & (tri == -1)
                       & (mesh == -1))
        else:
            hit, t, u, v, idx = reference.closest(tris, *ray, dtype=dtype)
            miss_ok = torch.ones_like(hit)
        pair = reference.pairs(tris[idx.clamp_min(0)], *ray)
        got = closest.compare((hit, t.float(), u.float(), v.float(), idx,
                               miss_ok), want, pair)
        k = pick.numel()
        totals["record_bad_share"] += got["record_bad_share"] * k
        for name in ("t_gap", "record_gap"):
            totals[name] = max(totals[name], got[name])
        n_all += k
    totals["record_bad_share"] /= max(n_all, 1)
    return totals

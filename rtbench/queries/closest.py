"""Query kind "closest": the closest-hit query, timed and checked.

The configuration's `query` states it: kind "closest", the watertight
test in float32, and the record a user reads (hit, t, u, v, triangle
index, mesh index).  `Program` is the system under test: the
configuration's scene built by the program and one timed call,
`Tracer.closest` and the record's six fields through `PacketHits` (the
lazy gathers are inside the call).  `check` holds the records of kept
calls to the plain reference (rtbench/reference.py), which takes nothing
from the program.
"""
from __future__ import annotations

import numpy as np
import torch

from rtbench import reference
from rtbench.traffic import generate

RECORD = ["hit", "t", "u", "v", "triangle_index", "mesh_index"]
CHECKS = ("t_gap", "record_gap", "record_bad_share")
CHECK_RAYS = 100  # the seed's streams of the rays checked of each call


def records(hits) -> tuple:
    """The record a closest-hit user reads, through PacketHits' fields."""
    return tuple(getattr(hits, k) for k in RECORD)


class Program:
    """The system under test: the configuration's scene built by the
    program on `device`, and one timed call."""

    def __init__(self, cell, positions, indices, device):
        import rtk_tpu_torch as rt

        q = cell["config"]["query"]
        if (q["test"], q["precision"], q["record"]) != (
                "watertight", "float32", RECORD):
            raise ValueError(f"query {q!r}: this kind runs the watertight "
                             f"closest-hit test in float32 with the record "
                             f"{RECORD}")
        b = cell["config"]["build"]
        if b["builder"] != "lbvh":
            raise ValueError(f"unknown builder {b['builder']!r}")
        self.rt = rt
        self.scene = rt.build_scene(
            (positions, indices),
            rt.BuildConfig(leaf_size=b["leaf_size"], branching=b["width"],
                           morton_bits=b["morton_bits"]), device=device)
        self.tracer = rt.Tracer(self.scene)
        self.tracer.packed

    def notes(self, n) -> list:
        """Earlier lines of a run: the batch beside the cost model's regime
        label, and the kernel builds of this process."""
        from rtk_tpu_torch.ops import packet_trace
        from rtk_tpu_torch.utils.costmodel import dispatch_bound

        builds = {str(k): v for k, v in packet_trace.BUILD_SECONDS.items()}
        return [f"batch {n} rays: dispatch_bound {dispatch_bound(n)}",
                f"kernel builds this process {builds}"]

    def rays(self, batch):
        return self.rt.Rays(origin=batch["origin"],
                            direction=batch["direction"],
                            min_t=batch["min_t"], max_t=batch["max_t"])

    def __call__(self, rays) -> tuple:
        return records(self.tracer.closest(rays))


def compare(got, want, pair):
    """The check's numbers on one sample.  got: the records judged (hit, t,
    u, v, the soup index of the named triangle or -1 where it is not in
    the soup, and whether a ray's miss fields are the miss record); want:
    the reference's closest (hit, t, u, v, index); pair: the reference's
    test of each ray against the triangle `got` names.
      t_gap: the widest |t - t_ref| / max(1, |t_ref|) over rays both hit;
      record_gap: the widest gap between a hit's t (relative, as above),
        u and v and the reference's test of the triangle it names;
      record_bad_share: the share of rays whose hit flag differs from the
        reference's, or that hit a triangle the reference's test does not
        hit there, or that miss with other than the miss record."""
    hit, t, u, v, idx, miss_ok = got
    rh, rt_, _, _, _ = want
    ph, pt, pu, pv = pair
    both = hit & rh
    t_gap = ((t - rt_).abs() / rt_.abs().clamp_min(1.0))[both]
    named = hit & (idx >= 0) & ph
    rec = torch.stack([(t - pt).abs() / pt.abs().clamp_min(1.0),
                       (u - pu).abs(), (v - pv).abs()])[:, named]
    bad = (hit != rh) | (hit & ~named) | (~hit & ~miss_ok)
    return {
        "t_gap": float(t_gap.max()) if t_gap.numel() else 0.0,
        "record_gap": float(rec.max()) if rec.numel() else 0.0,
        "record_bad_share": float(bad.sum()) / max(hit.numel(), 1),
    }


def check(cell, kept, batches, soup, seed, dtype=None):
    """Hold each kept call's records on a seeded sample of its rays to the
    reference -> compare's numbers over all kept calls (the share over all
    sampled rays, the gaps the widest).  dtype: judge the reference computed
    in that precision in the program's place (the control) instead."""
    m = int(cell["traffic"]["check"]["rays"])
    totals = {k: 0.0 for k in CHECKS}
    n_all = 0
    for j, (b, rec) in enumerate(kept):
        x = batches[b]
        n = x["origin"].shape[0]
        host = generate.rng(seed, CHECK_RAYS + j)
        pick = torch.as_tensor(np.sort(host.choice(n, min(m, n),
                                                   replace=False)),
                               device=soup.device)
        ray = [x[k][pick] for k in ("origin", "direction", "min_t", "max_t")]
        want = reference.closest(soup, *ray)
        if dtype is None:
            hit, t, u, v, tri, mesh = (r[pick] for r in rec)
            # The scene is one mesh: triangle k of mesh 0 is soup row k.
            ok = (mesh == 0) & (tri >= 0) & (tri < soup.shape[0])
            idx = torch.where(ok, tri.long(), -1)
            miss_ok = ((t == ray[3]) & (u == 0) & (v == 0) & (tri == -1)
                       & (mesh == -1))
        else:
            hit, t, u, v, idx = reference.closest(soup, *ray, dtype=dtype)
            miss_ok = torch.ones_like(hit)
        pair = reference.pairs(soup[idx.clamp_min(0)], *ray)
        got = compare((hit, t.float(), u.float(), v.float(), idx, miss_ok),
                      want, pair)
        k = pick.numel()
        totals["record_bad_share"] += got["record_bad_share"] * k
        for name in ("t_gap", "record_gap"):
            totals[name] = max(totals[name], got[name])
        n_all += k
    totals["record_bad_share"] /= max(n_all, 1)
    return totals

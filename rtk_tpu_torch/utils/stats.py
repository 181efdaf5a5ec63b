"""Observability: build and trace statistics and the logging callback
(rtk_tpu.utils.stats in PyTorch).

The reference's only observability is a printf-style user callback invoked
at phase starts and per node (rtk.h:95,102-103; rtk.c:686-696).  The
callback contract is kept (log_fn(user, build, message)) and extended with
structured statistics: tree shape and SAH cost after a build, time and
per-ray traversal counts for traces (the kernel's stats variant), and
torch.profiler hooks.

`span(name)` marks a stage of the call path as a profiler range: the
Tracer's query (`rtk.tracer.*`), the packet front end and its steps
(`rtk.packet_trace.*`) and PacketHits' lazy gathers (`rtk.hits.*`).
Spans are recorded exactly while a torch profiler records
(`profiler_trace`, or any torch.profiler.profile), on the clock of the
card's kernel records; otherwise a span is a shared null context.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import os
import time
from typing import Callable, Optional

import numpy as np
import torch

STEP_BLOCK = 128  # rays per block of steps_per_block
_NO_SPAN = contextlib.nullcontext()  # a span while no profiler records


class BuildLogger:
    """Parity: rtk_log_fn (rtk.h:95) -- log_fn(user, build, message)."""

    def __init__(self, log_fn: Optional[Callable] = None, user=None,
                 build=None):
        self.log_fn = log_fn
        self.user = user
        self.build = build

    def log(self, message: str):
        if self.log_fn is not None:
            self.log_fn(self.user, self.build, message)


@dataclasses.dataclass
class SceneStats:
    """Structural statistics of a built Scene."""

    num_tris: int
    num_leaves: int
    num_wide_nodes: int  # reachable wide nodes
    max_depth: int
    avg_leaf_occupancy: float  # triangles per leaf / leaf_size
    avg_child_occupancy: float  # non-empty slots per reachable wide node
    sah_cost: float  # sum over nodes of child_area/root_area

    def __str__(self):
        return (
            f"tris={self.num_tris} leaves={self.num_leaves} "
            f"wide_nodes={self.num_wide_nodes} depth={self.max_depth} "
            f"leaf_occ={self.avg_leaf_occupancy:.2f} "
            f"child_occ={self.avg_child_occupancy:.2f} "
            f"sah={self.sah_cost:.1f}"
        )


def log_build(scene, logger: BuildLogger,
              per_node: bool = False) -> SceneStats:
    """Per-level build log through the rtk-style callback: a post-build
    walk emitting one line per depth level plus the structural summary.
    per_node=True adds the reference's one line per node (rtk.c:1426)."""
    st = scene_stats(scene)
    logger.log(f"build: {st.num_tris} tris -> {st.num_wide_nodes} wide "
               f"nodes, {st.num_leaves} leaves, depth {st.max_depth}")
    child = scene.node_child.cpu().numpy()
    counts = {}
    stack = [(0, 1)]
    while stack:
        node, depth = stack.pop()
        counts[depth] = counts.get(depth, 0) + 1
        if per_node:
            slots = child[node]
            n_int = int((slots >= 0).sum())
            n_leaf = int((slots <= -2).sum())
            logger.log(f"build: node {node} depth {depth}: "
                       f"{n_int} children, {n_leaf} leaves")
        for s_ in child[node]:
            if s_ >= 0:
                stack.append((int(s_), depth + 1))
    for depth in sorted(counts):
        logger.log(f"build: level {depth}: {counts[depth]} nodes")
    logger.log(f"build: SAH cost {st.sah_cost:.2f}, child occupancy "
               f"{st.avg_child_occupancy:.2f}, leaf occupancy "
               f"{st.avg_leaf_occupancy:.2f}")
    return st


def scene_stats(scene) -> SceneStats:
    """Walk the wide tree on the host and report shape/cost statistics."""
    child = scene.node_child.cpu().numpy()
    cmin = scene.node_min.cpu().numpy()
    cmax = scene.node_max.cpu().numpy()

    def area(lo, hi):
        d = np.maximum(hi - lo, 0.0)
        return 2.0 * (d[..., 0] * d[..., 1] + d[..., 1] * d[..., 2]
                      + d[..., 2] * d[..., 0])

    root_area = max(float(area(scene.bounds_min.cpu().numpy(),
                               scene.bounds_max.cpu().numpy())), 1e-20)
    seen_nodes = 0
    occupancy = 0
    sah = 0.0
    max_depth = 0
    stack = [(0, 1)]
    while stack:
        node, depth = stack.pop()
        seen_nodes += 1
        max_depth = max(max_depth, depth)
        live = 0
        for w, s in enumerate(child[node]):
            if s == -1:
                continue
            live += 1
            sah += float(area(cmin[node, w], cmax[node, w])) / root_area
            if s >= 0:
                stack.append((int(s), depth + 1))
        occupancy += live
    return SceneStats(
        num_tris=scene.num_tris,
        num_leaves=scene.num_leaves,
        num_wide_nodes=seen_nodes,
        max_depth=max_depth,
        avg_leaf_occupancy=scene.num_tris / max(
            scene.num_leaves * scene.leaf_size, 1),
        avg_child_occupancy=occupancy / max(seen_nodes, 1),
        sah_cost=sah,
    )


@dataclasses.dataclass
class TraceStats:
    rays: int
    seconds: float
    mrays_per_s: float
    steps_per_block: Optional[float] = None  # packet engine only
    device: str = ""  # what the time was measured on

    def __str__(self):
        extra = (f" steps/block={self.steps_per_block:.0f}"
                 if self.steps_per_block else "")
        return (f"{self.rays} rays in {self.seconds * 1e3:.2f} ms = "
                f"{self.mrays_per_s:.2f} Mrays/s on {self.device}{extra}")


def steps_per_block(steps: torch.Tensor, block: int = STEP_BLOCK) -> float:
    """Mean over `block`-ray blocks of the block's largest per-ray step
    count: a block's critical path, the nearest analogue of the TPU
    kernel's per-block steps."""
    n = steps.shape[0]
    pad = (-n) % block
    s = torch.cat([steps, steps.new_zeros(pad)]).reshape(-1, block)
    return float(s.amax(dim=1).double().mean())


def mixed_axis_share(direction: torch.Tensor, warp: int = 32) -> float:
    """Share of the consecutive `warp`-ray groups of `direction` ((N, 3),
    in the order given; a short last group counts) whose rays' shear axes
    differ.  A ray's shear axis is the kernel's kz: its largest |d|
    component, ties x, then y, then z (a NaN component gives z).

    The kernel takes its per-axis leaf copies only where a warp's active
    lanes share the axis, so this is an upper bound on the share of leaf
    phases that take the copy reading the axis from the ray: a leaf
    phase's lanes are a subset of the warp."""
    n = direction.shape[0]
    if n == 0:
        return 0.0
    a = direction.abs()
    top = a.amax(dim=1)
    kz = torch.where(a[:, 0] == top, 0, torch.where(a[:, 1] == top, 1, 2))
    # A short last group padded with its own last ray's axis.
    kz = torch.cat([kz, kz[-1:].expand((-n) % warp)]).reshape(-1, warp)
    mixed = kz.amax(dim=1) != kz.amin(dim=1)
    return float(mixed.double().mean())


def measure_trace(tracer, rays, iters: int = 5, mode: str = "closest",
                  with_steps: bool = False) -> TraceStats:
    """Time a trace through a Tracer, and optionally count its traversal
    steps.

    On a CUDA device the `iters` calls are timed with CUDA events after a
    warm-up call, and the last result is read back to the host; on the CPU
    with the host clock.  with_steps (packet engine): one more trace
    through the kernel's stats variant on unsorted rays, as the reference
    reads its per-block counters (rtk_tpu/utils/stats.py:184-207)."""
    run = tracer.closest if mode == "closest" else tracer.any
    dev = rays.device
    hits = run(rays)
    float(hits.t[:1].sum())
    if dev.type == "cuda":
        start, end = (torch.cuda.Event(enable_timing=True)
                      for _ in range(2))
        start.record()
        for _ in range(iters):
            hits = run(rays)
        end.record()
        float(hits.t[:1].sum())  # a real readback of the last result
        end.synchronize()
        dt = start.elapsed_time(end) / 1e3 / iters
        where = torch.cuda.get_device_name(dev)
    else:
        t0 = time.perf_counter()
        for _ in range(iters):
            hits = run(rays)
        float(hits.t[:1].sum())
        dt = (time.perf_counter() - t0) / iters
        where = str(dev)

    steps = None
    if with_steps and tracer.engine == "packet":
        from rtk_tpu_torch.ops.packet_trace import trace_packets

        _, counts = trace_packets(tracer.packed, rays, mode=mode,
                                  watertight=tracer.config.watertight,
                                  sort_rays=False, stats=True)
        steps = steps_per_block(counts[0])
    return TraceStats(rays=rays.count, seconds=dt,
                      mrays_per_s=rays.count / dt / 1e6,
                      steps_per_block=steps, device=where)


def span(name: str):
    """A context that records `name` as a profiler range while a torch
    profiler records, and a shared null context otherwise, so that a span
    costs a flag check when nothing records.  The range is the profiler's
    C++ one, as torch marks its own compiled graphs: under a recording
    profiler torch.profiler.record_function costs about eight times as
    much a span (two dispatched ops and their own records)."""
    if torch.autograd._profiler_enabled():
        return torch._C._profiler._RecordFunctionFast(name)
    return _NO_SPAN


@contextlib.contextmanager
def profiler_trace(log_dir: str, annotation: Optional[str] = None):
    """Profile everything inside the block with torch.profiler (CPU, and
    the card when there is one) and write a Chrome trace to
    log_dir/trace.json: the port's spans (`span`) and the card's kernels
    on one timeline.  Yields the profiler (key_averages() for sums by
    kernel and span).  annotation: a span around the block."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        if annotation is None:
            yield prof
        else:
            with span(annotation):
                yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def annotate(name: str):
    """Decorator: group a function's work under the span `name` in
    profiler traces."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)

        return inner

    return wrap

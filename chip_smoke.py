"""Drive rtk_tpu_torch's main path once on one CUDA GPU and check it.

    python3 chip_smoke.py

Phases (each prints one line):
  1. build the CUDA kernels from csrc/ (the traversal, the coherence key
     and the unsort in one library) and print the toolchain and card;
  2. the kernel against its plain PyTorch version on cornell_box at 64^2
     and blob(6) (81,920 triangles) at 512^2, LBVH leaf 4 and step-
     quantized SAH leaf 16 tables: closest, any, filter_mask, defer_uv,
     each with its time and bound;
  3. the main path at full size through the user entry points:
     build_scene(blob(6)) -> Tracer(scene).closest / .any on 8192^2
     morton-ordered camera rays made on the card; the hit count must be
     within 5000 of 41,019,791; then the kernel against its plain version
     on the same tables and rays, both timed with CUDA events, and the
     any-hit launch alone with its own bound; the coherence key's kernels
     (csrc/coherence_key.cu) alone at 8192^2 beside the eager plain
     version on the card, and at 1024^2 bit-equal to the plain version
     on a CPU copy (keys that differ from the plain version on the card
     counted, not checked); the unsort (csrc/unsort.cu) alone on the
     kernel's outputs, bit-equal to its plain version's index-puts;
  4. record parity of the step-quantized SAH tables at 512^2 against the
     C++ oracle (native/rtk_oracle.cpp), at the bench's thresholds;
  5. the instanced path (BASELINE config 5, bench.py:757-801): 125
     instances of blob(6) (10.24M instanced triangles) traced at 1024^2
     through trace_closest_instanced_packets and the kernel's roots
     variant, on the merged LBVH forest and the step-quantized SAH
     forest; held against one flat 10.24M-triangle world-space scene
     traced by Tracer.closest, the two forests against each other, the
     kernel against its plain version (whole trace on a 256^2 subset, and
     the round-0 traversal alone at full size, grouped by instance as the
     rounds launch it, its roots checked once before the timed launches),
     and 1 candidate against 12 (the exact residual);
  6. the filtered-query and statistics path at the main path's width:
     build_scene(blob(6)) -> Tracer(scene, tri_mask) on 8192^2 rays with
     jit_filter predicates (the kernel's filter variant) held against the
     mask filter bit for bit and against the caller's ray identity through
     the coherence sort; per-ray counts through the stats variant and
     measure_trace; both variants against their plain versions (512^2,
     LBVH leaf 4 and SAH leaf 16 tables, and alone at 8192^2); the stack
     engine (trace_closest with an unmarked callable) against the filter
     kernel at 1024^2; save -> load of the scene and the SAH tables; and
     the rtk compat shim (a 4-thread task build, single-ray
     rtk_trace_ray / rtk_trace_ray_filter on 64 rays);
  7. the last two variants at full width: 16-wide tables (one step-
     quantized SAH tree of blob(6), leaf 16, packed 8- and 16-wide, 8192^2
     morton rays with sort_rays=False; the widths against each other, the
     16-wide kernel against its plain version, with counts at 512^2), and
     BASELINE
     config 3, the atrium (409,600 tris, bench.py:590-664): SAH tables at
     both widths, 1024^2 primaries and one cosine-sampled diffuse bounce
     (its coherence keys bit-equal to the plain version on a CPU copy)
     traced at both widths, with the mixed-axis share of the bounce and
     of the primaries in their sorted order (the 32-ray warps whose shear
     axes differ) and K1 closest alone on the 8-wide bounce beside its
     bound (the kernels line's packet_trace row, "bounce8"), and the fused
     grid march on the atrium's LBVH through Tracer(engine="march")
     against the flat trace (closest on the bounce and the primaries,
     any-hit masks), with the march kernel
     against its plain version on the bounce (counts on a 256^2 subset);
  8. dynamic scenes: build once, then per frame refit the bounds to moved
     vertices, regather the kernel's tables and trace (refit,
     repack_bounds, refit_packed_binary, Tracer.refresh,
     trace_packets_refit, trace_packets_refit_frames).  8a is BASELINE
     config 4 as the reference's bench defines it (bench.py:683-737):
     deforming_grid(n=96), 18,432 triangles, 256^2 morton rays, LBVH leaf 8
     without wide nodes, three single frames and the 32-frame clip on the
     refittable step-quantized SAH (leaf 16) and the LBVH tables.  8b is
     the same path at deforming_grid(n=1024), 2,097,152 triangles, 2048^2
     rays, three single frames and an 8-frame clip.  Every frame's refit
     tables are held against a fresh build of that frame (same hit mask, t
     within 1e-5); the refit and repack (csrc/refit.cu's launches) equal
     their plain versions on CPU copies bit for bit, and refit to the
     built soup gives back the built tables in value (the build's eager
     reductions on the card may take the other sign of a zero bound: the
     line counts such zeros); the front-ends equal refit -> repack ->
     trace_packets and each other bit for bit; the kernel equals its plain
     version on refit tables; a refreshed masked Tracer equals a fresh
     one, a refreshed march Tracer meets phase 7's bar, a 16-wide refit
     equals the 8-wide one, and trace_packets_chunked equals
     trace_packets.  Reported per frame: refit, repack, kernel and
     end-to-end ms beside a fresh build, the refit's and repack's launches,
     their issue rate beside their plain versions', their card ms alone
     and their byte bound (tools/torch_profile_refit.py's rows; the
     kernels line's refit and repack rows), and the card's idle share
     over 8a's clip from torch.profiler;
  9. the render path (models/path.py).  9a: render_path on BASELINE
     config 3, the atrium (409,600 triangles as four meshes, the ceiling
     the light; LBVH leaf 16 through Tracer), 1024^2 primaries and 4
     bounces with compaction and the Morton re-sort, and once each without
     the sort, without compaction, with an exact-size take (all but the
     first again with a black floor, where the buckets shrink), with defer_uv
     and with the march as bounce_tracer (the march kernel alone on each
     bounce batch it was handed, beside its bound): per bounce the rays
     launched and
     alive, trace and shade + sort + take ms, the kernel alone beside its
     bound from the stats variant; per call ms, Mrays/s, host syncs,
     device events and the card's idle share.  Checked by the furnace
     identity (albedo 1, emission and background e: radiance / e is a
     whole number in [1, bounces + 1] whose sum is the number of live rays
     traced), exactly, with compaction on and off; by the bounce draws
     handed in by ray (uniforms), whose radiance is bit for bit the same
     with compaction and the sort on or off, the render loop's counters
     (traces, rows, host syncs, shade launches) beside the kernel
     launches and batches; by the shade kernel (csrc/shade.cu) against
     the eager plain pass on every batch of that frame, every output bit
     for bit, each alone beside its bound and the plain pass (the eager
     pass's shade + sort + take ms beside this smoke's); and by the kernel
     against its plain version on the whole batches that call launched
     (every bounce batch for closest, bounce 2's for any).  9b:
     render_direct (a lit pixel's shadow ray is unoccluded on the stack
     engine, 128^2 subset) and render_ao with 8 samples, the any-hit
     kernel against its plain version on the whole shadow batch and on the
     first and last AO batch, and alone on the shadow batch and the first
     AO batch beside its bound.  9c: BASELINE config 5's 4-bounce instanced
     wavefront (bench.py:803-894) on phase 5's two forests with pooled
     calibrated round caps, every bounce batch held against the plain
     version of the rounds and against the flat world-space Tracer at
     phase 5's bars, and its candidate slab's kernel (csrc/candidates.cu,
     one launch a trace and one a residual, counted) alone beside its
     bound and the plain slab, bit for bit; the rounds' glue
     (csrc/rounds.cu, two launches a round, counted) alone at a 1024^2
     batch in a round's order beside its bound and the eager glue, bit for
     bit;
 10. the Tracer's remaining engines on the atrium (BASELINE config 3, LBVH
     leaf 16 through build_scene, 1024^2 primaries and phase 7's cosine
     bounce): Tracer(engine="grid") closest on the bounce and the
     primaries and any on the bounce, once with calibrate_caps' caps and
     once under an odd/even tri_mask with filter_mask; engine="binned"
     closest and any; trace_packets_kz_binned; render_path with the grid
     as bounce_tracer; and engine="stackless" on 256^2 subsets.  Each is
     held against the flat trace at tests/test_grid.py's bar (kz-binned
     bit for bit, the render at 9a's), the grid rounds against their
     plain version (256^2 closest, 128^2 any and masked, counts
     included), and one launch whose roots include leaf entries against
     the plain version.  It prints each engine's steady ms beside the
     flat trace's, the grid's per-round counts, its replayed round
     launches and the host syncs of one grid and one binned call.
 11. sharding (parallel/shard.py) on meshes whose entries all name the
     one card (what every shard's launches and the combine cost, not
     scaling): ray sharding of the headline (build_scene(blob(6)), 8192^2
     morton rays) on default_mesh() and on 4 entries, bit for bit against
     trace_packets; trace_closest_sharded and a ray_index filter on a
     256^2 subset, bit for bit against trace_closest (the filter sees the
     caller's index); the atrium (409,600 tris, BuildConfig(8, 8)) in 4
     parts and on the hybrid 2 x 2 mesh, 1024^2 primaries and phase 7's
     cosine bounce, closest against one scene of the same config (equal
     hit masks, t within 1e-6*(1+|t|), another triangle only at an
     exact-t tie) and any-hit records equal to those of the part that
     produced them; config 5 (phase 5's LBVH forest and rays) through
     trace_instanced_sharded and the atrium bounce through
     trace_grid_sharded, each on 2 entries, against the unsharded calls
     (phase 5's and tests/test_grid.py's bars).  It prints each call's
     ms beside the unsharded call's, the builds, the residual sizes and
     the device events of one call;
 12. serving from AOT artifacts (utils/aot.py): the headline's program
     (phase 11's tables, 8192^2, closest) and config 4's refit program
     (8a's grid, 256^2, 8 frames of its clip) exported with the kernel
     library embedded; a fresh server process with no nvcc on its PATH
     and CUDA_HOME an empty directory loads the scene blobs and the
     artifacts, traces and writes its outputs, which must equal this
     process's direct calls bit for bit, with no kernel build in the
     server (its launches are not in this process's counts).  It prints
     the export ms, the artifacts' bytes, the server's time from spawn
     to its first result, and the loaded artifacts' steady ms beside the
     direct calls'.
 13. the cost model (utils/costmodel.py) against a cut sweep of the main
     path: build_scene(blob(6)) -> Tracer.closest on Morton primaries at
     64^2, 128^2, 256^2, 1024^2 and 4096^2, each size measured as
     tools/torch_costmodel_fit.py measures it (the host wall ms of one
     synchronised call, the host's ms to issue it, the card's busy ms in
     profiler windows that open with spins, steps_per_block), beside
     StepModel().trace_ms from the measured steps_per_block, its
     relative error and dispatch_bound's answer.
     dispatch_bound must be True at 64^2 and False at 4096^2, and agree
     there with the measured regime (the card's busy ms against this
     run's fixed cost of a call, read as the fit reads DISPATCH_MS); the
     prediction must be within COST_TOL at 1024^2 and 4096^2; auto_pkt a
     multiple of 128; the 64^2 records and steps_per_block equal the plain
     version's.
 14. the profiling entry points, tools/torch_profile_trace.py and
     tools/torch_profile_refit.py (the counterparts of the JAX round's
     tools/profile_trace.py and tools/profile_refit.py).  14a: the
     dispatch probe (csrc/dispatch_probe.cu, o = x + 1, built in phase 1)
     on an (8, 128) f32 tensor of +-0, +-inf, NaNs, subnormals and values
     near 2^24 made from a seed, bit-equal to one eager x + 1.0 on the
     card, PROBE_LAUNCHES equal to the calls made; per launch of the
     probe and of the eager op, the host's us at the pipelined issue rate
     (the floor), the card's us back to back (CUDA events, queued behind
     a spin on the card) and one synchronised call's us (latency), beside
     phase 13's fixed cost and 1024^2 error.  14b: the trace tool's
     stages on blob(6) (BuildConfig(8, 8)) at 1024^2, (b) the kernel alone
     on rows stacked once, (c) trace_packets unsorted, (d) sorted (sorted
     == unsorted and (b) == (c) bit for bit), Tracer.closest at 64^2
     and 128^2 (phase 13's fixed-cost points) and at 1024^2 (sorted), and
     that call's coherence key alone.  14c: the refit tool's
     stages on config 4 (refit, repack, their plain versions, trace, the
     fused frame, one tiny op, a 1024^2 trace; the fused frame's tables
     and records == the stages') and its refit rows (launches, issue
     rate beside the plain versions', card ms alone, byte bound).  Every
     stage: ms at the issue rate, Mrays/s, the wall of one synchronised
     call (outside the profiler), the card's busy ms and device events
     of one call, wall less busy, and events x each floor.
Then the kernel summary as one JSON line (per traversal variant:
launches on its path, max |kernel - plain|, kernel and plain ms, and the
bound: the least time the card could take, from the per-ray box and
triangle tests the stats variant counts; and gap_ms, the sum over the
launches that `launches` counts of each one's ms less its own bound,
every launch of a main path held and replayed alone when its run ends,
launches_ms and launches_bound_ms being the two sums; a row for the
coherence key, its bound the 28 bytes a ray it must move, one for the
unsort, its bound its 40 bytes a ray; and a row for the dispatch probe,
its bound the bytes it reads and writes), the card's
name and power limit, and, last, {"ok": true, "device": {...}}.
Exits non-zero, printing no result, when there is no CUDA device or any
phase fails.  Imports no jax.
"""
import dataclasses
import importlib
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import numpy as np
import torch

# Expected 8192^2 hit count for blob(6) under the bench camera: the same
# for every topology (ties change which triangle wins, never whether a
# ray hits); device-made rays move a few silhouette hits.
HEADLINE_EXPECT_HITS = 41_019_791
HEADLINE_HIT_TOL = 5000
CAM = dict(eye=(0, 0, 3.0), look_at=(0, 0, 0), up=(0, 1, 0), fov_deg=45)
REL_TOL = 1e-6  # |kernel - plain| <= REL_TOL * (1 + |plain|) for t, u, v
# Phase 5: BASELINE config 5 as bench.py:757-801 builds it.
INST_CAM = dict(eye=(7, 6.5, 8), look_at=(2.2, 2.2, 2.2), up=(0, 1, 0),
                fov_deg=55)
INST_CANDIDATES = 12
FLAT_T_TOL = 2e-4  # t within FLAT_T_TOL*(1+|t|) of the flat world trace...
FLAT_T_SHARE = 0.9999  # ...on this share of common hits (and hit
FLAT_HIT_MISMATCH = 1e-4  # mismatches on at most this share of the rays)
FOREST_T_TOL = 1e-5  # LBVH forest vs SAH forest, and 1 vs 12 candidates
# Phase 6 predicates (each its own filter build, all built in phase 1).
ODD_TRI = lambda c: c.triangle_index % 2 == 1  # noqa: E731
EVEN_RAY = lambda c: c.ray_index % 2 == 0  # noqa: E731
# tests/test_packet.py:330's predicate, on triangle and t.
TRI_T = lambda c: (c.triangle_index % 3 == 1) & (c.t > 2.0)  # noqa: E731
STACK_T_REL = 1e-6  # stack engine vs filter kernel (test_packet.py:337)
STACK_SAME_TRI = 0.95  # share of hits on the same triangle (exact ties)
# The bound, from the published H100 SXM peaks.  67 TFLOP/s of f32
# outside the tensor cores counts a fused multiply-add as two operations.
# The function is computed without fusing (-fmad=false: watertightness
# rests on unfused products), so each f32 operation below is one
# instruction, issued at half that rate.
PEAK_F32_INSTR = 67e12 / 2  # f32 instructions a second
PEAK_BYTES = 3.35e12  # HBM bytes a second
# f32 operations per test, counted from csrc/packet_trace.cu: a child box
# test is 6 sub, 6 mul, 6 max/min and 1 compare; a triangle test is 9 sub
# to translate 3 vertices, 15 mul/add to shear them, 9 mul/sub for the
# edge functions, 3 compares for the exact-zero test, 4 min/max, 2 add and
# 1 divide for 1/det, 6 mul/add for t and 4 compares.  Per-ray set-up,
# the near-to-far sort of the children and a filter's predicate are not
# counted.
OPS_PER_BOX = 19
OPS_PER_TRI = 53
# The instance candidate slab's kernel (csrc/candidates.cu): about 30 f32
# operations a box test (6 sub, 6 mul, 12 min/max, the compare and the
# list's test), 32 bytes read a ray (origin, direction, min_t, max_t) and
# 8 C + 4 written (the candidates' ids and distances, the overflow).
SLAB_OPS_PER_TEST = 30
SLAB_READ_BYTES_PER_RAY = 32
# An instanced round's glue (csrc/rounds.cu), bytes a row: the object rays
# read the ray and instance ids (8 each), origin and direction (12 each),
# min t and best t (4 each) and write origin and direction, min t, max t,
# root and instance (40); the scatter reads the ray id, hit flag, t and
# best t (17) and, where the row improves, u, v, slot and instance (16
# more) and writes t, u, v, slot and instance (20).
ROUND_RAYS_BYTES = 48 + 40
ROUND_SCATTER_BYTES = 17
ROUND_SCATTER_BETTER_BYTES = 16 + 20
# Phase 7: the atrium's camera and bounce (bench.py:623-633).
ATRIUM_CAM = dict(eye=(0, 6, 9), look_at=(0, 2, 0), up=(0, 1, 0),
                  fov_deg=60)
WIDTH_T_TOL = 1e-6  # 16- vs 8-wide: t within WIDTH_T_TOL*(1+|t|) (test_w16)
WIDTH_MISMATCH = 1e-6  # ...and at most this share of the rays disagreeing
# Phase 8: BASELINE config 4's camera (bench.py:689) and the bar between
# tables refit to a frame and a fresh build of it (tests/test_packet.py:
# 106-119): the same hit mask, |t| within REFIT_T_TOL.
GRID_CAM = dict(eye=(0, 3, 4), look_at=(0, 0, 0), up=(0, 1, 0), fov_deg=50)
REFIT_T_TOL = 1e-5
# The Scene's fields a refit writes, and those that hold the boxes of
# leaf ranges (where the sign of a zero bound depends on the pairing).
SCENE_BOXES = ("bin_min", "bin_max", "leaf_min", "leaf_max", "tri_v",
               "node_min", "node_max", "bounds_min", "bounds_max")
NODE_BOXES = ("bin_min", "bin_max", "node_min", "node_max")

# Phase 9: the render path.  The atrium's parts in scenes.atrium()'s order
# (floor, ceiling, 64 columns, 4 walls) as four meshes; the ceiling is the
# light (albedo 0: a path that reaches it ends), so bounce batches shrink.
ATRIUM_PARTS = (32768, 32768, 64 * 5120, 4 * 4096)
ATRIUM_ALBEDO = [[0.7, 0.7, 0.7], [0.0, 0.0, 0.0], [0.6, 0.3, 0.3],
                 [0.7, 0.7, 0.7]]
ATRIUM_EMISSION = [[0, 0, 0], [4.0, 4.0, 4.0], [0, 0, 0], [0, 0, 0]]
ATRIUM_DARK_ALBEDO = [[0.0, 0.0, 0.0]] + ATRIUM_ALBEDO[1:]  # a black floor
ATRIUM_LIGHT = dict(light_pos=(0.5, 7.0, 1.0), light_color=(30.0, 30.0, 30.0))
FURNACE_E = 0.5  # emission and background of the furnace runs
ENGINE_SHARE = 0.999  # rays whose radiance agrees (1e-4) across engines
WAVE_EPS = 1e-3  # bench.py:812, :828: the wavefront's offset and min_t
# Phase 13: the cost model's cut sweep of the main path (blob(6), Morton
# primaries); its sizes of 1024^2 and above give this run's fixed cost of a
# call as the fit reads DISPATCH_MS (their intercept).  COST_TOL bounds
# |predicted - measured| / measured at COST_CHECK_SIDES (PERF.md §6).
COST_SIDES = (64, 128, 256, 1024, 4096)
COST_CHECK_SIDES = (1024, 4096)
COST_TOL = 0.25
# Phase 14: the profiling entry points.  The probe's input seed; the
# floors' back-to-back calls (tools' timeit: FLOOR_ITERS x FLOOR_BATCHES);
# launches a card-time window, queued behind a spin of SPIN_CYCLES on the
# card (about 20 ms at 1.98 GHz, far longer than the host takes to issue
# them); synchronised calls a wall median.
PROBE_SEED = 14
FLOOR_ITERS, FLOOR_BATCHES = 200, 5
CARD_REPS = 200
SPIN_CYCLES = 40_000_000
WALL_CALLS = 11
# torch.profiler windows of one call each; host_split keeps the one with
# the most device events (a window can drop events, never add some).
# Each opens and closes with PAD_SPINS spins on the card (padded_profile).
PROFILE_WINDOWS = 3
PAD_SPINS = 256
SPIN_KERNEL = "spin_kernel"  # torch.cuda._sleep's kernel (ATen's Sleep.cu)
FIXED_SIDES = (64, 128)  # the cost model's fixed-cost points (phase 13)
KEY_EVENTS_SIDE = 1024  # 14b: the sorted Tracer.closest and its key alone
# The coherence key's bound (csrc/coherence_key.cu): it must read a ray's
# origin and direction (24 bytes) and write its key (4), and it does about
# 44 f32 operations a ray (the direction's norm 5, the probe 9, the two
# bounds 12, the quantisation 18).
KEY_BYTES_PER_RAY = 28
KEY_OPS_PER_RAY = 44
# The unsort's bound (csrc/unsort.cu): a ray's index (8 bytes) and its four
# outputs (16) read, the four written (16); no arithmetic.
UNSORT_BYTES_PER_RAY = 40
# The rows pass's bound (csrc/ray_rows.cu) on a sorted batch: a ray's index
# (8 bytes), origin and direction (24) and bounds (8) read, its eight f32
# rows (32) written; no arithmetic.  An expanded origin (stride 0: one eye
# read in place) takes its 12 bytes off.
ROWS_BYTES_PER_RAY = 72
# The shade pass's bound (csrc/shade.cu) on a bounce with the uniforms
# handed in, bounces but the last: the record's hit flag, t and slot (9
# bytes), the triangle (36) and its mesh (4), the ray's origin and
# direction (24), throughput (12), path index (8), two uniforms (8) and
# radiance (12) read; radiance (12), the next ray (32), throughput (12)
# and key (4) written.  The last bounce reads the hit, slot, mesh,
# throughput, index and radiance and writes the radiance.
SHADE_BYTES_PER_RAY = 173
SHADE_LAST_BYTES_PER_RAY = 53
# Phase 9a's shade + sort + take a bounce when the shade pass was eager
# (this frame, on an H100 80GB HBM3 at 700 W), beside each bounce's now.
EAGER_SHADE_SORT_TAKE_MS = [1.481, 1.453, 1.457, 1.488, 0.158]


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def smi(query):
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


def timed(fn, reps=1, warm=True):
    """(result, ms per call) with CUDA events, after one warm-up call."""
    if warm:
        fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end) / reps


def compare(got, want, what):
    """hit and slot equal; t, u, v within REL_TOL*(1+|x|).  -> max |err|."""
    check(torch.equal(got.hit, want.hit), f"{what}: hit differs")
    check(torch.equal(got.slot, want.slot), f"{what}: slot differs")
    err = 0.0
    for f in ("t", "u", "v"):
        a, b = getattr(got, f), getattr(want, f)
        d = (a - b).abs()
        check(bool((d <= REL_TOL * (1 + b.abs())).all()),
              f"{what}: {f} differs by {float(d.max())}")
        err = max(err, float(d.max()))
    return err


def as_hits(out):
    """The (t, u, v, slot, ...) outputs of a kernel or its plain version
    as compare() reads them."""
    return SimpleNamespace(t=out[0], u=out[1], v=out[2], slot=out[3],
                           hit=out[3] >= 0)


def config5(rt, dev, subdivisions=6, side=5):
    """BASELINE config 5 (bench.py:757-801): one blob BLAS (81,920
    triangles at subdivisions=6), side^3 instances on a grid with scales
    and offsets from default_rng(7).  -> (blas soup, transforms,
    InstancedScene, {table name: PackedInstancedScene})."""
    from rtk_tpu_torch.builder.sah import build_sah_forest
    from rtk_tpu_torch.testing import scenes

    blas_tris = scenes.blob(subdivisions=subdivisions)[0]
    blas = rt.build_from_soup(
        blas_tris, config=rt.BuildConfig(branching=8, leaf_size=8),
        device=dev)
    n_inst = side ** 3
    tf = np.zeros((n_inst, 3, 4), np.float32)
    rng5 = np.random.default_rng(7)
    for i in range(n_inst):
        gx, gy, gz = i % side, (i // side) % side, i // (side * side)
        sc = 0.35 + 0.15 * rng5.random()
        tf[i, :, :3] = np.eye(3, dtype=np.float32) * sc
        tf[i, :, 3] = (np.array([gx, gy, gz], np.float32) * 1.1
                       + rng5.random(3).astype(np.float32) * 0.2)
    iscene = rt.build_instanced([blas], np.zeros(n_inst, np.int64), tf)
    sah, sah_roots = build_sah_forest(
        [blas_tris], rt.BuildConfig(branching=8, leaf_size=16), device=dev)
    return blas_tris, tf, iscene, {
        "lbvh8": rt.pack_instanced(iscene),
        "sahq16": rt.pack_instanced(iscene, packed=sah,
                                    packed_roots=sah_roots)}


def compare_instanced(got, want, what, t_tol):
    """Hits equal; t within t_tol*(1+|t|); the instance equal except where
    two instances tie on t exactly.  -> (max |t err|, instance ties)."""
    (gh, gi), (wh, wi) = got, want
    check(torch.equal(gh.hit, wh.hit), f"{what}: hit differs")
    d = (gh.t - wh.t).abs()[wh.hit]
    check(bool((d <= t_tol * (1 + wh.t.abs()[wh.hit])).all()),
          f"{what}: t differs by {float(d.max()) if d.numel() else 0.0}")
    differ = gi != wi
    check(bool((gh.t == wh.t)[differ].all()),
          f"{what}: instance differs off a t tie")
    return (float(d.max()) if d.numel() else 0.0), int(differ.sum())


def check_vs_flat(hits, flat_hits, what):
    """An instanced trace against the flat world-space trace of the same
    rays: hit mismatches on at most FLAT_HIT_MISMATCH of the rays, t
    within FLAT_T_TOL*(1+|t|) on FLAT_T_SHARE of the common hits.
    -> (mismatches, that share)."""
    n = hits.hit.numel()
    mism = int((hits.hit != flat_hits.hit).sum())
    both = hits.hit & flat_hits.hit
    ok_t = ((hits.t - flat_hits.t).abs()
            <= FLAT_T_TOL * (1 + flat_hits.t.abs()))[both]
    share = float(ok_t.float().mean()) if ok_t.numel() else 1.0
    check(mism <= FLAT_HIT_MISMATCH * n,
          f"{what} vs flat: {mism} hit mismatches of {n}")
    check(share >= FLAT_T_SHARE, f"{what} vs flat: t agrees on {share}")
    return mism, share


def round0(iscene, ps, rays, grouped=True, keyed=False):
    """Round 0 of trace_closest_instanced_packets over `rays`: every ray
    whose nearest instance entry precedes its max_t, in that instance's
    object space, from its BLAS root.  grouped: in the rounds' order
    (stable by instance, instancing.py's round loop), else in the batch's;
    keyed: by instance, then by the object-space rays' coherence key.
    -> ((8, m) rows, (m,) roots, ms of the ordering: the sort by instance,
    or the key and its sort)."""
    from rtk_tpu_torch import instancing
    from rtk_tpu_torch.ops.morton import ray_coherence_key

    cand, cand_t, _ = instancing._instance_candidates(iscene, rays, 1)
    rows = torch.nonzero(cand_t[:, 0] < rays.max_t).squeeze(1)
    inst = cand[rows, 0].long()
    o, d = instancing._object_rays(iscene.object_from_world[inst],
                                   rays.origin[rows], rays.direction[rows])
    order_ms = 0.0
    if keyed:
        order, order_ms = timed(lambda: torch.sort(
            inst << 31 | ray_coherence_key(o, d).long(), stable=True).indices,
            reps=3)
    elif grouped:
        order, order_ms = timed(lambda: torch.sort(inst, stable=True).indices,
                                reps=3)
    else:
        order = torch.arange(rows.numel(), device=rows.device)
    rows, inst, o, d = rows[order], inst[order], o[order], d[order]
    comps = torch.cat([o.T, d.T, rays.min_t[rows][None],
                       rays.max_t[rows][None]]).contiguous()
    return (comps, ps.packed_roots[iscene.instance_blas[inst]].contiguous(),
            order_ms)


def roots_alone(pt, packed, comps, roots, reps=3):
    """(outputs, ms) of the roots variant's launch alone: the roots are
    checked once first, as pack_instanced checks the rows the rounds
    gather them from, and the timed launches make no host sync."""
    pt._check_roots(roots, packed.nodes, comps, packed.branching,
                    packed.tris.shape[0] // packed.leaf_size)
    return timed(lambda: pt._kernel(
        packed.nodes, packed.tris, comps, leaf_size=packed.leaf_size,
        stack_size=packed.stack_size, mode="closest", watertight=True,
        qmask=None, defer_uv=False, roots=roots, filter_fn=None,
        ray_index=None, stats=False, branching=packed.branching,
        roots_in_range=True), reps=reps)


def phase5(rt, dev, launch_log, subdivisions=6, side=5, width=1024,
           stride=16):
    """The instanced path at BASELINE config 5; returns its record and
    what phase 9c traces again (the tables, transforms, rays and the flat
    world-space Tracer).  The counts are read around the main-path traces
    only."""
    from rtk_tpu_torch import instancing
    from rtk_tpu_torch.ops import packet_trace
    from rtk_tpu_torch.testing import scenes

    sync = torch.cuda.synchronize if dev.type == "cuda" else lambda: None
    sync()
    t0 = time.perf_counter()
    blas_tris, tf, iscene, tables = config5(rt, dev, subdivisions, side)
    sync()
    build_ms = (time.perf_counter() - t0) * 1e3
    rays = scenes.camera_rays(**INST_CAM, width=width, height=width,
                              order="morton", device=dev, on_device=True)
    n = rays.count
    kw = dict(max_candidates=INST_CANDIDATES)

    # The main path: both tables, counts zeroed just before, read after.
    sync()
    packet_trace.KERNEL_LAUNCHES = packet_trace.ROOTS_LAUNCHES = 0
    launch_log.start(5)
    main, stats = {}, {}
    for name, ps in tables.items():
        stats[name] = {}
        main[name] = rt.trace_closest_instanced_packets(ps, rays, **kw,
                                                        stats=stats[name])
    sync()
    launch_log.stop()
    launches = {"kernel": packet_trace.KERNEL_LAUNCHES,
                "roots": packet_trace.ROOTS_LAUNCHES}
    rec = {"rays": n, "instances": iscene.num_instances,
           "instanced_tris": iscene.total_triangles,
           "build_ms": round(build_ms, 1), "launches": launches,
           "depth": {k: ps.packed.depth for k, ps in tables.items()}}
    for name, (hits, inst) in main.items():
        check(bool(torch.isfinite(hits.t[hits.hit]).all()),
              f"{name}: non-finite hit t")
        check(torch.equal(inst >= 0, hits.hit), f"{name}: instance vs hit")
        rec[name] = {"hits": int(hits.hit.sum()), **stats[name]}

    # The two forests agree.
    rec["forest_max_t_err"], rec["forest_inst_ties"] = compare_instanced(
        main["sahq16"], main["lbvh8"], "sahq16 vs lbvh8", FOREST_T_TOL)

    # Steady state (CUDA events, after the warm-up above), and calibrated
    # round caps, which must not change the answer.
    for name, ps in tables.items():
        _, ms = timed(lambda: rt.trace_closest_instanced_packets(ps, rays,
                                                                 **kw),
                      reps=3, warm=False)
        caps = instancing.calibrate_round_caps(ps, rays, **kw)
        capped = rt.trace_closest_instanced_packets(ps, rays, **kw,
                                                    round_caps=caps)
        compare_instanced(capped, main[name], f"{name} capped", 0.0)
        _, capped_ms = timed(lambda: rt.trace_closest_instanced_packets(
            ps, rays, **kw, round_caps=caps), reps=3, warm=False)
        rec[name].update(ms=round(ms, 3), mrays_s=round(n / ms / 1e3, 3),
                         calibrated_caps=caps, capped_ms=round(capped_ms, 3))

    # Kernel vs plain: the whole trace on a 256^2 strided subset, and 1
    # candidate (the exact residual) against 12.
    sub = rays[::stride]
    max_err = 0.0
    for name, ps in tables.items():
        got, k_ms = timed(lambda: rt.trace_closest_instanced_packets(
            ps, sub, **kw), warm=False)
        want, p_ms = timed(lambda: rt.trace_closest_instanced_packets(
            ps, sub, **kw, plain=True), warm=False)
        max_err = max(max_err, compare(got[0], want[0], f"{name} subset"))
        check(torch.equal(got[1], want[1]), f"{name} subset: instance")
        res = {}
        one = rt.trace_closest_instanced_packets(ps, sub, max_candidates=1,
                                                 stats=res)
        err1, ties1 = compare_instanced(one, got, f"{name} 1 vs 12",
                                        FOREST_T_TOL)
        rec[name].update(subset_ms=round(k_ms, 3), subset_plain_ms=round(
            p_ms, 2), subset_rays=sub.count, c1_residual=res["residual"],
            c1_max_t_err=err1, c1_inst_ties=ties1)

    # The roots variant alone vs its plain version on round 0 as the rounds
    # launch it (LBVH forest): the launch alone, its roots checked once
    # before the timed window.  Beside it the row's former measure, kept
    # for comparison: the same rays in world Morton order through the
    # wrapper, which checks the roots (a host sync) on every call.
    ps = tables["lbvh8"]
    comps, roots, _ = round0(iscene, ps, rays)
    tk = dict(leaf_size=ps.packed.leaf_size, stack_size=ps.packed.stack_size,
              roots=roots)
    k_out, kernel_ms = roots_alone(packet_trace, ps.packed, comps, roots)
    p_out, plain_ms = timed(lambda: packet_trace.packet_trace_reference(
        ps.packed.nodes, ps.packed.tris, comps, **tk), warm=False)
    max_err = max(max_err, compare(as_hits(k_out), as_hits(p_out),
                                   "round-0 roots kernel/plain"))
    # 4 more bytes a ray: its root row.
    b_ms, b_by = bound(packet_trace.packet_trace_kernel(
        ps.packed.nodes, ps.packed.tris, comps, **tk, stats=True)[4],
        ps.packed, 52)
    w_comps, w_roots, _ = round0(iscene, ps, rays, grouped=False)
    _, world_ms = timed(lambda: packet_trace.packet_trace(
        ps.packed.nodes, ps.packed.tris, w_comps, **{**tk, "roots": w_roots}),
        reps=3)
    rec.update(round0_rays=comps.shape[1], kernel_ms=kernel_ms,
               kernel_ms_world_order=roots_alone(packet_trace, ps.packed,
                                                 w_comps, w_roots)[1],
               kernel_ms_world_order_wrapper=world_ms,
               plain_ms=round(plain_ms, 1), max_abs_err=max_err,
               bound_ms=b_ms, bound_by=b_by)
    del comps, roots, w_comps, w_roots, k_out, p_out

    # Independent check: the same rays through one flat scene of all the
    # transformed copies, built and traced through the flat entry points.
    world = (np.einsum("iab,tvb->itva", tf[:, :, :3], blas_tris)
             + tf[:, None, None, :, 3]).reshape(-1, 3, 3)
    sync()
    t0 = time.perf_counter()
    flat = rt.build_scene((world.reshape(-1, 3),
                           np.arange(world.shape[0] * 3).reshape(-1, 3)),
                          device=dev)
    del world
    flat_tracer = rt.Tracer(flat)
    fh = flat_tracer.closest(rays)
    sync()
    flat_ms = (time.perf_counter() - t0) * 1e3
    for name, (hits, _) in main.items():
        mism, share = check_vs_flat(hits, fh, name)
        rec[name].update(flat_hit_mismatch=mism, flat_t_share=share)
    rec.update(flat_tris=flat.num_tris, flat_hits=int(fh.hit.sum()),
               flat_build_trace_ms=round(flat_ms, 1))
    return rec, SimpleNamespace(tables=tables, tf=tf, iscene=iscene,
                                rays=rays, flat=flat_tracer)


def bound(counts, packed, bytes_per_ray=48):
    """(bound_ms, bound_by) of one traversal: the larger of its f32
    operations over the card's f32 instruction rate and its bytes over the
    card's memory rate.  Operations: the child box tests and triangle
    tests this run's rays needed (the stats variant's counts: live child
    slots of the popped nodes; real, unmasked rows of the popped leaves),
    times OPS_PER_BOX and OPS_PER_TRI.  Bytes: bytes_per_ray (rays in,
    outputs out, and any per-ray extras) per ray and the two tables once."""
    c = counts.double().sum(dim=1)
    ops = float(c[3]) * OPS_PER_BOX + float(c[4]) * OPS_PER_TRI
    nbytes = (counts.shape[1] * bytes_per_ray
              + packed.nodes.numel() * 4 + packed.tris.numel() * 4)
    t_ops, t_bytes = ops / PEAK_F32_INSTR * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


class LaunchLog:
    """Each launch of the kernel while a main path runs, held so that it
    can be replayed alone when the run ends: stop() launches each again
    with stats for its bound (its own counts on its own tables and rays)
    and once more between CUDA events for its time, so that a kernels-line
    row's gap is the sum over its launches of (ms - bound) at each
    launch's own shape.  The replays are not main-path launches: the
    launch counters are put back after them.  The held inputs would raise
    the card's peak allocation, so stop() restarts that count and peak_gib
    reads the peak outside the logged windows."""

    COUNTERS = ("KERNEL_LAUNCHES", "ROOTS_LAUNCHES", "FILTER_LAUNCHES",
                "STATS_LAUNCHES", "W16_LAUNCHES", "MARCH_LAUNCHES",
                "ANY_LAUNCHES", "MASK_LAUNCHES", "DEFER_UV_LAUNCHES")

    def __init__(self, pt):
        self.pt, self.phase, self.held, self.done = pt, None, [], []
        self.last, self.peak = [], 0
        trace, march = pt._kernel, pt.packet_march_kernel

        def logged(fn, is_march):
            def run(nodes, tris, rays8, **kw):
                if self.phase is not None:
                    self.held.append((self.phase, fn, is_march, nodes, tris,
                                      rays8, kw))
                return fn(nodes, tris, rays8, **kw)
            return run

        pt._kernel = logged(trace, False)
        pt.packet_march_kernel = logged(march, True)
        # The card's front-end steps hold the launchers themselves.
        pt.CARD = dataclasses.replace(pt.CARD, trace=pt._kernel,
                                      march=pt.packet_march_kernel)

    def start(self, phase):
        """Hold every launch from here on, tagged with `phase`."""
        self.peak = max(self.peak, torch.cuda.max_memory_allocated())
        self.phase = phase

    def stop(self):
        """End the window and replay what it held -> self.last, the
        window's replays, each {"phase", "flags", "rays", "ms", "bound_ms",
        "bound_by"}, also appended to self.done; the held tensors go."""
        pt, self.phase = self.pt, None
        saved = {c: getattr(pt, c) for c in self.COUNTERS}
        start, end = (torch.cuda.Event(enable_timing=True)
                      for _ in range(2))
        self.last = []
        for phase, fn, is_march, nodes, tris, rays8, kw in self.held:
            flags = {"march": is_march, "any": kw.get("mode") == "any",
                     "mask": kw.get("qmask") is not None,
                     "defer_uv": bool(kw.get("defer_uv")),
                     "roots": kw.get("roots") is not None,
                     "filter": kw.get("filter_fn") is not None,
                     "stats": bool(kw.get("stats")),
                     "w16": kw.get("branching", 8) == 16}
            counts = fn(nodes, tris, rays8, **{**kw, "stats": True})[4]
            start.record()
            fn(nodes, tris, rays8, **kw)
            end.record()
            torch.cuda.synchronize()
            b_ms, b_by = bound(counts, SimpleNamespace(nodes=nodes, tris=tris),
                               40 if flags["defer_uv"] else 48)
            self.last.append({"phase": phase, "flags": flags,
                              "rays": rays8.shape[1],
                              "ms": start.elapsed_time(end),
                              "bound_ms": b_ms, "bound_by": b_by})
        self.done += self.last
        self.held = []
        for c, v in saved.items():
            setattr(pt, c, v)
        torch.cuda.reset_peak_memory_stats()

    def reset_peak(self):
        self.peak = 0
        torch.cuda.reset_peak_memory_stats()

    def peak_gib(self):
        """The card's peak allocation since reset_peak() (or the start),
        outside the logged windows, in GiB."""
        return round(max(self.peak, torch.cuda.max_memory_allocated())
                     / 2 ** 30, 2)

    def row(self, phases, flag=None):
        """(launches, sum of ms, sum of bound_ms, gap ms) over the replayed
        launches of `phases` that have `flag` (None: all)."""
        sel = [(r["ms"], r["bound_ms"]) for r in self.done
               if r["phase"] in phases and (flag is None or r["flags"][flag])]
        ms = sum(m for m, _ in sel)
        b_ms = sum(b for _, b in sel)
        return len(sel), ms, b_ms, ms - b_ms


def key_check(morton, rays, what):
    """The coherence key's kernels on `rays` (CUDA) against the plain
    version on a CPU copy, bit for bit (fails otherwise), and against the
    plain version on the card (the count of keys that differ, not checked:
    torch's CUDA norm may contract to a fused multiply-add) -> record with
    max_abs_err, the largest |kernel - plain| over the CPU copy's keys."""
    got = morton.ray_coherence_key(rays.origin, rays.direction)
    cpu = morton.ray_coherence_key_reference(rays.origin.cpu(),
                                             rays.direction.cpu())
    err = int((got.cpu().long() - cpu.long()).abs().max())
    check(err == 0, f"{what}: {int((got.cpu() != cpu).sum())} coherence keys "
          "differ from the plain version's on the CPU")
    plain = morton.ray_coherence_key_reference(rays.origin, rays.direction)
    return {"rays": rays.count, "max_abs_err": err,
            "cuda_plain_differ": int((got != plain).sum())}


def bits_equal(a, b):
    """Equal bit for bit (NaN padding rows of the triangle table too)."""
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


def same_hits(a, b, what, fields=("hit", "slot", "t", "u", "v")):
    for f in fields:
        check(torch.equal(getattr(a, f), getattr(b, f)),
              f"{what}: {f} differs")


def phase6(rt, dev, launch_log, v6, f6, cam512, width=8192,
           stack_width=1024):
    """The filtered-query and statistics path; returns its record and the
    two kernel entries.  Counts are zeroed just before the main-path
    traces and read just after."""
    from rtk_tpu_torch import compat, tasks
    from rtk_tpu_torch.ops import packet_trace as pt
    from rtk_tpu_torch.ops.morton import ray_coherence_key
    from rtk_tpu_torch.testing import scenes
    from rtk_tpu_torch.trace.packed import pack_scene
    from rtk_tpu_torch.utils import serialize
    from rtk_tpu_torch.utils.stats import measure_trace

    odd, even_ray, tri_t = (rt.jit_filter(f)
                            for f in (ODD_TRI, EVEN_RAY, TRI_T))
    n_tris = f6.shape[0]
    mask = np.where(np.arange(n_tris) % 2 == 1, 1, 2).astype(np.uint32)
    scene = rt.build_scene((v6, f6), device=dev)
    tracer = rt.Tracer(scene, tri_mask=mask)
    packed = tracer.packed
    rays = scenes.camera_rays(**CAM, width=width, height=width,
                              order="morton", device=dev, on_device=True)
    n = rays.count
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(8)]

    # ---- the main path: counts zeroed just before, read just after ----
    torch.cuda.synchronize()
    pt.KERNEL_LAUNCHES = pt.FILTER_LAUNCHES = pt.STATS_LAUNCHES = 0
    launch_log.start(6)
    ev[0].record()
    h_f = tracer.closest(rays, filter_fn=odd)
    ev[1].record()
    a_f = tracer.any(rays, filter_fn=odd)
    ev[2].record()
    h_r = tracer.closest(rays, filter_fn=even_ray)
    ev[3].record()
    _, counts = pt.trace_packets(packed, rays, stats=True)
    ev[4].record()
    ms_stats = measure_trace(tracer, rays, iters=1, with_steps=True)
    torch.cuda.synchronize()
    launch_log.stop()
    launches = {"kernel": pt.KERNEL_LAUNCHES, "filter": pt.FILTER_LAUNCHES,
                "stats": pt.STATS_LAUNCHES}
    check(launches["filter"] >= 3 and launches["stats"] >= 2,
          f"phase 6 launches {launches}")
    rec = {"rays": n, "launches": launches,
           "filter_closest_ms": ev[0].elapsed_time(ev[1]),
           "filter_any_ms": ev[1].elapsed_time(ev[2]),
           "ray_filter_ms": ev[2].elapsed_time(ev[3]),
           "stats_trace_ms": ev[3].elapsed_time(ev[4]),
           "measure_trace": {"ms": ms_stats.seconds * 1e3,
                             "mrays_s": ms_stats.mrays_per_s,
                             "steps_per_block": ms_stats.steps_per_block}}

    # The filter kernel against an independent answer: the mask filter.
    h_m = tracer.closest(rays, filter_mask=1)
    a_m = tracer.any(rays, filter_mask=1)
    same_hits(h_f, h_m, "odd filter vs mask, closest")
    same_hits(a_f, a_m, "odd filter vs mask, any", ("hit", "slot", "t"))
    base = tracer.closest(rays)
    even = torch.arange(n, device=dev) % 2 == 0
    check(torch.equal(h_r.hit, base.hit & even),
          "ray filter: hit != base & even ray")
    rec.update(filter_hits=int(h_f.hit.sum()), any_hits=int(a_f.hit.sum()),
               ray_filter_hits=int(h_r.hit.sum()),
               base_hits=int(base.hit.sum()))
    del h_m, a_m, a_f, h_r, even

    # Per-ray counts of the 8192^2 trace (caller order).
    check(bool((counts[0] == counts[1] + counts[2]).all()),
          "stats: steps != internal + leaf pops")
    rec["per_ray_mean"] = per_ray_mean(counts)

    # Each variant alone against its plain version at 8192^2, on the
    # coherence-sorted rays the front end hands the kernel.
    order = torch.sort(ray_coherence_key(rays.origin, rays.direction),
                       stable=True).indices
    comps = torch.cat([rays.origin.T, rays.direction.T, rays.min_t[None],
                       rays.max_t[None]])[:, order].contiguous()
    ridx = order.to(torch.int32)
    del order
    kw = dict(leaf_size=packed.leaf_size, stack_size=packed.stack_size)
    entries = {}
    # The mask and defer_uv launches alone at this size, each with the
    # bound of its own pops (40 bytes a ray when u and v are not written).
    rec["alone_8192"] = {}
    for name, extra, per_ray in (("mask", dict(qmask=1), 48),
                                 ("defer_uv", dict(defer_uv=True), 40)):
        _, k_ms = timed(lambda: pt.packet_trace_kernel(
            packed.nodes, packed.tris, comps, **kw, **extra), reps=3)
        b_ms, b_by = bound(pt.packet_trace_kernel(
            packed.nodes, packed.tris, comps, **kw, **extra, stats=True)[4],
            packed, per_ray)
        rec["alone_8192"][name] = {"ms": k_ms, "bound_ms": b_ms,
                                   "bound_by": b_by}
    for name, extra, per_ray in (
            ("packet_trace_filter", dict(filter_fn=odd, ray_index=ridx), 52),
            ("packet_trace_stats", dict(stats=True), 68)):
        k_out, k_ms = timed(lambda: pt.packet_trace_kernel(
            packed.nodes, packed.tris, comps, **kw, **extra), reps=3)
        p_out, p_ms = timed(lambda: pt.packet_trace_reference(
            packed.nodes, packed.tris, comps, **kw, **extra), warm=False)
        err = compare(as_hits(k_out), as_hits(p_out), f"{name} 8192^2")
        if "stats" in extra:
            check(torch.equal(k_out[4], p_out[4]), "stats 8192^2: counts")
            run_counts = k_out[4]
        else:  # the filter trace's own pops
            run_counts = pt.packet_trace_kernel(
                packed.nodes, packed.tris, comps, **kw, **extra,
                stats=True)[4]
        b_ms, b_by = bound(run_counts, packed, per_ray)
        entries[name] = {"ms": k_ms, "plain_ms": p_ms, "max_abs_err": err,
                         "bound_ms": b_ms, "bound_by": b_by}
        del k_out, p_out, run_counts
    del comps, ridx

    # Both variants against their plain versions at 512^2 on LBVH leaf 4
    # and SAH step-quant leaf 16 tables: t, u, v, slot and counts equal,
    # and any-hit counts <= closest-hit counts per ray.
    tables = {"lbvh4": pack_scene(scene, tri_mask=mask),
              "sahq16": rt.build_sah_packed(
                  (v6, f6), rt.BuildConfig(leaf_size=16), tri_mask=mask,
                  step_quant=True, device=dev)}
    p512 = {}
    for topo, pk in tables.items():
        cnt = {}
        for mode in ("closest", "any"):
            for fname, flt, kwx in (("odd", odd, {}), ("ray", even_ray, {}),
                                    ("tri_t_defer", tri_t,
                                     {"defer_uv": True})):
                what = f"512/{topo}/{mode}/{fname}"
                got, _ = timed(lambda: pt.trace_packets(
                    pk, cam512, mode=mode, filter_fn=flt, stats=True, **kwx),
                    warm=False)
                want = pt.trace_packets_reference(
                    pk, cam512, mode=mode, filter_fn=flt, stats=True, **kwx)
                entries["packet_trace_filter"]["max_abs_err"] = max(
                    entries["packet_trace_filter"]["max_abs_err"],
                    compare(got[0], want[0], what))
                check(torch.equal(got[1], want[1]), f"{what}: counts")
                cnt[mode, fname] = got[1]
                p512[what] = int(got[0].hit.sum())
        for fname in ("odd", "ray", "tri_t_defer"):
            check(bool((cnt["any", fname] <= cnt["closest", fname]).all()),
                  f"512/{topo}/{fname}: any counts > closest counts")
    rec["hits_512"] = p512

    # The stack engine (unmarked callable, plain PyTorch on the card)
    # against the filter kernel at 1024^2.
    rays1k = scenes.camera_rays(**CAM, width=stack_width,
                                height=stack_width, order="morton",
                                device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hs = rt.trace_closest(scene, rays1k, filter_fn=TRI_T)
    torch.cuda.synchronize()
    stack_ms = (time.perf_counter() - t0) * 1e3
    hk = tracer.closest(rays1k, filter_fn=tri_t)
    check(torch.equal(hs.hit, hk.hit), "stack vs filter kernel: hit")
    d = ((hs.t - hk.t).abs() / hk.t.abs().clamp(min=1e-30))[hk.hit]
    check(bool((d <= STACK_T_REL).all()), "stack vs filter kernel: t")
    same = float((hs.triangle_index == hk.triangle_index)[hk.hit]
                 .float().mean())
    check(same >= STACK_SAME_TRI, f"stack vs filter kernel: same {same}")
    rec.update(stack_ms=stack_ms, stack_hits=int(hs.hit.sum()),
               stack_max_t_rel=float(d.max()) if d.numel() else 0.0,
               stack_same_tri=same)
    del hs, hk

    # Save -> load on the card: tables bit-equal, traces equal.
    plain_tracer = rt.Tracer(scene)
    buf = io.BytesIO()
    nbytes = rt.save_scene(scene, buf)
    loaded = rt.load_scene(buf.getvalue(), device=dev)
    for f in serialize._FIELDS:
        check(bits_equal(getattr(loaded, f), getattr(scene, f)),
              f"load_scene: {f}")
    same_hits(rt.Tracer(loaded).closest(rays1k),
              plain_tracer.closest(rays1k), "loaded scene trace")
    sah = tables["sahq16"]
    buf = io.BytesIO()
    rt.save_packed_scene(sah, buf)
    lsah = rt.load_any(buf.getvalue(), device=dev)
    for f in serialize._PACKED_FIELDS:
        check(bits_equal(getattr(lsah, f), getattr(sah, f)),
              f"load_packed_scene: {f}")
    check(lsah.depth == sah.depth, "load_packed_scene: depth")
    same_hits(pt.trace_packets(lsah, rays1k), pt.trace_packets(sah, rays1k),
              "loaded SAH trace")
    rec.update(scene_blob_bytes=nbytes, sah_blob_bytes=len(buf.getvalue()))

    # The task build on 4 host threads and the rtk shim's one-shot build
    # equal build_scene; then 64 single rays through the shim.
    t0 = time.perf_counter()
    tscene = tasks.build_scene_tasks([(v6, f6)], num_threads=4, device=dev)
    rec["task_build_4_threads_ms"] = (time.perf_counter() - t0) * 1e3
    cscene = compat.rtk_build_scene(compat.RtkSceneDesc([(v6, f6)]),
                                    device=dev)
    for f in serialize._FIELDS:
        check(bits_equal(getattr(tscene, f), getattr(scene, f)),
              f"build_scene_tasks: {f}")
        check(bits_equal(getattr(cscene, f), getattr(scene, f)),
              f"rtk_build_scene: {f}")
    del tscene
    sub = rays1k[::rays1k.count // 64]
    check(sub.count == 64, "64 single rays")
    want = plain_tracer.closest(sub)
    want_f = plain_tracer.closest(sub, filter_fn=odd)
    for i in range(sub.count):
        ray = compat.RtkRay(tuple(sub.origin[i].tolist()),
                            tuple(sub.direction[i].tolist()),
                            float(sub.min_t[i]), float(sub.max_t[i]))
        for (found, hit), w in (
                (compat.rtk_trace_ray(cscene, ray), want),
                (compat.rtk_trace_ray_filter(
                    cscene, ray, lambda user, r, c: ODD_TRI(c)), want_f)):
            check(found == bool(w.hit[i]), f"compat ray {i}: hit")
            if found:
                wt = float(w.t[i])
                check(abs(hit.t - wt) <= STACK_T_REL * abs(wt),
                      f"compat ray {i}: t {hit.t} vs {wt}")
    rec["compat_rays"] = sub.count
    rec["compat_hits"] = int(want.hit.sum())
    rec["compat_filter_hits"] = int(want_f.hit.sum())
    for name in entries:
        entries[name]["launches"] = launches[name.split("_")[-1]]
    return rec, entries


def width_mismatch(a, b):
    """Rays where two traces of one tree at two widths disagree: the hit,
    t beyond WIDTH_T_TOL*(1+|t|), or the triangle off an exact-t tie."""
    both = a.hit & b.hit
    bad = (a.hit != b.hit) | (both & (
        ((a.t - b.t).abs() > WIDTH_T_TOL * (1 + b.t.abs()))
        | ((a.triangle_index != b.triangle_index) & (a.t != b.t))))
    return int(bad.sum())


def march_parity(got, ref, what, field="slot"):
    """tests/test_grid.py::_assert_parity: equal hit masks, t within
    1e-6*(1+|t|), another triangle (`field` differs) only at an exact-t tie
    -> (max |t err|, ties)."""
    check(torch.equal(got.hit, ref.hit),
          f"{what}: {int((got.hit != ref.hit).sum())} hit mismatches")
    d = (got.t - ref.t).abs()
    check(bool((d <= 1e-6 * (1 + ref.t.abs())).all()),
          f"{what}: t differs by {float(d.max())}")
    differ = getattr(got, field) != getattr(ref, field)
    check(torch.equal(got.t[differ], ref.t[differ]),
          f"{what}: another triangle off a t tie")
    return float(d.max()), int(differ.sum())


def sah_widths(rt, dev, soup):
    """One step-quantized SAH tree with leaf 16 (the C++ oracle), packed
    8- and 16-wide -> ({8: PackedScene, 16: PackedScene}, seconds)."""
    from rtk_tpu_torch.trace.packed import pack_binary_tree
    from rtk_tpu_torch.utils.native_sah import NativeOracle

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tree = NativeOracle(soup.reshape(-1, 9), leaf_max=16,
                        step_quant=True).export_tree()
    tables = {w: pack_binary_tree(soup, *tree, leaf_size=16, branching=w,
                                  device=dev) for w in (8, 16)}
    torch.cuda.synchronize()
    return tables, time.perf_counter() - t0


def kernel_alone(pt, packed, comps, **kw):
    """(outputs, ms) of the kernel alone on (8, N) rows, 3 timed calls."""
    return timed(lambda: pt.packet_trace_kernel(
        packed.nodes, packed.tris, comps, leaf_size=packed.leaf_size,
        stack_size=packed.stack_size, branching=packed.branching, **kw),
        reps=3)


def rows_of(rays):
    return torch.cat([rays.origin.T, rays.direction.T, rays.min_t[None],
                      rays.max_t[None]]).contiguous()


def per_ray_mean(counts):
    """The stats variant's (5, N) counts as per-ray means by name."""
    return dict(zip(("steps", "internal_pops", "leaf_pops", "box_tests",
                     "tri_tests"), counts.double().mean(dim=1).tolist()))


def cosine_bounce(rt, prim, cam, seed=0):
    """One cosine-sampled diffuse bounce off the primaries' hits
    (bench.py:623-633): origins pushed 1e-3 along the geometric normal,
    min_t 1e-3, dead where the primary missed."""
    from rtk_tpu_torch.models.path import cosine_sample, geometric_normal

    nrm = geometric_normal(prim, cam.direction)
    gen = torch.Generator(device=cam.device).manual_seed(seed)
    return rt.Rays(origin=prim.position() + 1e-3 * nrm,
                   direction=cosine_sample(gen, nrm),
                   min_t=torch.full((cam.count,), 1e-3, device=cam.device),
                   max_t=torch.where(prim.hit, float(np.float32(3.4e38)),
                                     0.0))


def phase7(rt, dev, launch_log, soup6, cam512, width=8192, atrium_width=1024,
           subset=256):
    """16-wide tables on the headline and the atrium bounce, and the grid
    march on the atrium; returns its record and the two kernel entries.
    Counts are zeroed just before each main-path trace and read just
    after; the comparisons with plain versions come after."""
    from rtk_tpu_torch.ops import morton
    from rtk_tpu_torch.ops import packet_trace as pt
    from rtk_tpu_torch.testing import scenes
    from rtk_tpu_torch.testing.grid import march_batch, trace_packets_march
    from rtk_tpu_torch.utils.stats import mixed_axis_share

    sync = torch.cuda.synchronize
    rec = {}
    w16 = {"launches": 0, "max_abs_err": 0.0}
    march = {"launches": 0, "max_abs_err": 0.0}

    # ---- K3 on the headline: one SAH tree of blob(6), two widths ----
    tables, rec["headline_build_s"] = sah_widths(rt, dev, soup6)
    rays = scenes.camera_rays(**CAM, width=width, height=width,
                              order="morton", device=dev, on_device=True)
    n = rays.count
    sync()
    pt.KERNEL_LAUNCHES = pt.W16_LAUNCHES = 0
    launch_log.start(7)
    h16 = pt.trace_packets(tables[16], rays, sort_rays=False)
    sync()
    launch_log.stop()
    w16["launches"] += pt.W16_LAUNCHES
    h8 = pt.trace_packets(tables[8], rays, sort_rays=False)
    mism = width_mismatch(h16, h8)
    check(mism <= WIDTH_MISMATCH * n,
          f"headline 16- vs 8-wide: {mism} of {n} rays disagree")
    comps = rows_of(rays)
    del rays, h8
    k_out, w16["ms"] = kernel_alone(pt, tables[16], comps)
    _, w8_ms = kernel_alone(pt, tables[8], comps)
    # The 16-wide kernel against its plain version on the same rows.
    p_out, w16["plain_ms"] = timed(lambda: pt.packet_trace_reference(
        tables[16].nodes, tables[16].tris, comps, leaf_size=16,
        stack_size=tables[16].stack_size, branching=16), warm=False)
    w16["max_abs_err"] = compare(as_hits(k_out), as_hits(p_out),
                                 "w16 kernel/plain 8192^2")
    del k_out, p_out
    counts = {w: pt.packet_trace_kernel(
        p.nodes, p.tris, comps, leaf_size=16, stack_size=p.stack_size,
        branching=w, stats=True)[4] for w, p in tables.items()}
    w16["bound_ms"], w16["bound_by"] = bound(counts[16], tables[16])
    rec["headline"] = {
        "rays": n, "hits": int(h16.hit.sum()), "width_mismatch": mism,
        "depth": {w: p.depth for w, p in tables.items()},
        "nodes": {w: p.num_nodes for w, p in tables.items()},
        "w16_kernel_ms": w16["ms"], "w8_kernel_ms": w8_ms,
        "w16_plain_ms": w16["plain_ms"],
        "w8_bound_ms": bound(counts[8], tables[8])[0],
        "per_ray_mean": {w: per_ray_mean(c) for w, c in counts.items()}}
    del comps, counts, h16
    # Both modes with their counts at 512^2 through the front end.
    for kw in ({}, {"mode": "any"}):
        got = pt.trace_packets(tables[16], cam512, sort_rays=False,
                               stats=True, **kw)
        want = pt.trace_packets_reference(tables[16], cam512,
                                          sort_rays=False, stats=True, **kw)
        w16["max_abs_err"] = max(w16["max_abs_err"], compare(
            got[0], want[0], f"w16 512^2 {kw}"))
        check(torch.equal(got[1], want[1]), f"w16 512^2 {kw}: counts")
    del tables

    # ---- the atrium: SAH tables at both widths, primaries, one bounce ----
    atr = scenes.atrium()
    tables, rec["atrium_sah_build_s"] = sah_widths(rt, dev, atr)
    cam = scenes.camera_rays(**ATRIUM_CAM, width=atrium_width,
                             height=atrium_width, order="morton", device=dev)
    prim = pt.trace_packets(tables[8], cam)
    bounce = cosine_bounce(rt, prim, cam)
    rec["key_bounce"] = key_check(morton, bounce, "atrium bounce")
    sync()
    pt.W16_LAUNCHES = 0
    launch_log.start(7)
    b16 = pt.trace_packets(tables[16], bounce)
    sync()
    launch_log.stop()
    w16["launches"] += pt.W16_LAUNCHES
    b8 = pt.trace_packets(tables[8], bounce)
    mism = width_mismatch(b16, b8)
    check(mism <= WIDTH_MISMATCH * bounce.count,
          f"atrium bounce 16- vs 8-wide: {mism} rays disagree")
    ms = {w: timed(lambda: pt.trace_packets(p, bounce), reps=3)[1]
          for w, p in tables.items()}
    w16["max_abs_err"] = max(w16["max_abs_err"], compare(
        b16, pt.trace_packets_reference(tables[16], bounce), "w16 bounce"))
    # Each kernel alone on the coherence-sorted rows it is handed.
    order = torch.sort(morton.ray_coherence_key(bounce.origin,
                                                bounce.direction),
                       stable=True).indices
    brows = rows_of(bounce)[:, order].contiguous()
    # The 32-ray warps whose shear axes differ, in the sorted order the
    # kernel is handed: they take the leaf test that reads the axis from
    # the ray.
    prim_order = torch.sort(morton.ray_coherence_key(cam.origin,
                                                     cam.direction),
                            stable=True).indices
    mixed = {"bounce": mixed_axis_share(bounce.direction[order]),
             "primary": mixed_axis_share(cam.direction[prim_order])}
    del order, prim_order
    bcounts = {w: pt.packet_trace_kernel(
        p.nodes, p.tris, brows, leaf_size=16, stack_size=p.stack_size,
        branching=w, stats=True)[4] for w, p in tables.items()}
    bms = {w: kernel_alone(pt, p, brows)[1] for w, p in tables.items()}
    b8_bound, b8_by = bound(bcounts[8], tables[8])
    rec["atrium"] = {
        "tris": atr.shape[0], "rays": cam.count,
        "primary_hits": int(prim.hit.sum()),
        "bounce_hits": int(b16.hit.sum()), "width_mismatch": mism,
        "depth": {w: p.depth for w, p in tables.items()},
        "bounce_ms": ms, "bounce_kernel_ms": bms,
        "mixed_axis_share": mixed,
        "per_ray_mean": {w: per_ray_mean(c) for w, c in bcounts.items()},
        # K1 closest on the bounce at 8 wide: the kernels line's yardstick
        # of incoherent rays.
        "k1_bounce8": {"ms": bms[8], "bound_ms": b8_bound,
                       "bound_by": b8_by, "share": b8_bound / bms[8],
                       "mixed_axis_share": mixed["bounce"]}}
    del tables, b8, b16, bcounts

    # ---- K2: the grid march on the atrium's LBVH (leaf 16) ----
    sync()
    t0 = time.perf_counter()
    scene = rt.build_from_soup(atr, config=rt.BuildConfig(leaf_size=16),
                               device=dev)
    tracer = rt.Tracer(scene, engine="march")
    flat = rt.Tracer(scene)
    sync()
    scene_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    grid = tracer.grid
    sync()
    grid_s = time.perf_counter() - t0
    pt.MARCH_LAUNCHES = 0
    launch_log.start(7)
    hm = tracer.closest(bounce)
    am = tracer.any(bounce)
    pm = tracer.closest(cam)
    sync()
    launch_log.stop()
    march["launches"] = pt.MARCH_LAUNCHES
    check(march["launches"] == 3, f"march launches {march['launches']}")
    parity = {"bounce": march_parity(hm, flat.closest(bounce), "bounce"),
              "primary": march_parity(pm, flat.closest(cam), "primary")}
    check(torch.equal(am.hit, flat.any(bounce).hit), "march any-hit mask")
    march_ms = timed(lambda: tracer.closest(bounce), reps=3)[1]
    flat_ms = timed(lambda: flat.closest(bounce), reps=3)[1]
    flat_kernel_ms = kernel_alone(pt, flat.packed, brows)[1]
    del brows
    mg, mrows, _ = march_batch(grid, bounce)
    cm = grid.cells_march
    mk = dict(leaf_size=cm.leaf_size, stack_size=cm.stack_size, grid=mg)
    k_out, march["ms"] = timed(lambda: pt.packet_march_kernel(
        cm.nodes, cm.tris, mrows, **mk), reps=3)
    # The march kernel against its plain version (one round of the plain
    # roots traversal per cell) on the same rows.
    p_out, march["plain_ms"] = timed(lambda: pt.packet_march_reference(
        cm.nodes, cm.tris, mrows, **mk), warm=False)
    march["max_abs_err"] = compare(as_hits(k_out), as_hits(p_out),
                                   "march kernel/plain")
    march["bound_ms"], march["bound_by"] = bound(
        pt.packet_march_kernel(cm.nodes, cm.tris, mrows, **mk,
                               stats=True)[4], cm)
    del mrows, k_out, p_out
    # Both modes with their counts on a subset, through the front end.
    sub = bounce[::(bounce.count // subset ** 2)]
    for mode in ("closest", "any"):
        got = trace_packets_march(grid, sub, mode=mode, stats=True)
        want = trace_packets_march(grid, sub, mode=mode, stats=True,
                                   plain=True)
        march["max_abs_err"] = max(march["max_abs_err"], compare(
            got[0], want[0], f"march subset {mode}"))
        check(torch.equal(got[1], want[1]), f"march subset {mode}: counts")
    _, counts = trace_packets_march(grid, bounce, stats=True)
    _, flat_counts = pt.trace_packets(flat.packed, bounce, stats=True)
    rec["march"] = {
        "scene_build_s": scene_s, "grid_build_s": grid_s,
        "dims": grid.dims, "occupied_cells": grid.n_occ,
        "cells_rows": cm.num_nodes, "cells_tris": cm.num_padded_tris,
        "bounce_hits": int(hm.hit.sum()), "primary_hits": int(pm.hit.sum()),
        "max_t_err_ties": parity, "march_bounce_ms": march_ms,
        "flat_bounce_ms": flat_ms, "kernel_ms": march["ms"],
        "flat_kernel_ms": flat_kernel_ms, "plain_ms": march["plain_ms"],
        "subset_rays": sub.count,
        "flat_bound_ms": bound(flat_counts, flat.packed)[0],
        "per_ray_mean": {"march": per_ray_mean(counts),
                         "flat": per_ray_mean(flat_counts)}}
    return rec, {"packet_trace_w16": w16, "packet_trace_march": march}


def refit_vs_fresh(got, fresh, what):
    """Tables refit to a frame against a fresh build of it: the same hit
    mask, t within REFIT_T_TOL (never counts: a refit box may be wider
    than a fresh one) -> max |t err| over the hits."""
    check(torch.equal(got.hit, fresh.hit),
          f"{what}: {int((got.hit != fresh.hit).sum())} hit mismatches "
          "against a fresh build")
    d = (got.t - fresh.t).abs()[fresh.hit]
    err = float(d.max()) if d.numel() else 0.0
    check(err <= REFIT_T_TOL, f"{what}: t differs from a fresh build by {err}")
    return err


def tables_equal(a, b, what, fields=("nodes", "tris", "tri_v")):
    for f in fields:
        check(bits_equal(getattr(a, f), getattr(b, f)), f"{what}: {f}")


def device_share(prof, frames):
    """The card's busy and idle share over a profiled window: the union
    of the device events' intervals over the span from the first one's
    start to the last one's end, and the device events a frame.  The
    spins that open a padded_profile window are left out."""
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and SPIN_KERNEL not in e.name)
    if not spans:
        return {"device_events": 0, "idle_share": None}
    busy, (cur_s, cur_e) = 0.0, spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    window = max(e for _, e in spans) - spans[0][0]
    return {"device_events": len(spans),
            "device_events_per_frame": len(spans) / frames,
            "busy_ms": busy / 1e3, "window_ms": window / 1e3,
            "idle_share": 1.0 - busy / window}


def profile_clip(run, frames, pt):
    """One warm run, one run on the host's clock (the time to enqueue the
    clip, then to drain it) and one in a kept_profile window -> the
    kernel's launches a frame, the two times and the window's record."""
    sync = torch.cuda.synchronize
    run()
    sync()
    before = pt.KERNEL_LAUNCHES
    t0 = time.perf_counter()
    run()
    enqueue_ms = (time.perf_counter() - t0) * 1e3
    sync()
    total_ms = (time.perf_counter() - t0) * 1e3
    per_frame = (pt.KERNEL_LAUNCHES - before) / frames
    return {"host_enqueue_ms": enqueue_ms, "enqueue_and_drain_ms": total_ms,
            "kernel_launches_per_frame": per_frame,
            **kept_profile(run, frames)[1]}


def phase8(rt, dev, launch_log, small=(96, 256, 32),
           big=(1024, 2048, 8)):
    """Dynamic scenes at BASELINE config 4 (8a) and at 2.1M triangles
    (8b); small and big are (grid n, image width, clip frames).  Returns
    its record and the kernel entries of the any, mask and defer_uv
    launches.  Counts are zeroed just before each main-path run and read
    just after; the comparisons and timings come after."""
    from rtk_tpu_torch import scene as tscene
    from rtk_tpu_torch.ops import packet_trace as pt
    from rtk_tpu_torch.testing import scenes
    from rtk_tpu_torch.trace import packed as tpacked
    from rtk_tpu_torch.trace.packed import (pack_binary_tree, pack_scene,
                                            refit_packed_binary,
                                            repack_bounds)
    from rtk_tpu_torch.utils.native_sah import NativeOracle

    prefit = load_tool("torch_profile_refit")
    sync = torch.cuda.synchronize
    cfg = rt.BuildConfig(branching=8, leaf_size=8, wide_nodes=False)
    flags = dict(defer_uv=True)
    counters = ("KERNEL_LAUNCHES", "ANY_LAUNCHES", "MASK_LAUNCHES",
                "DEFER_UV_LAUNCHES")
    launches = dict.fromkeys(counters, 0)
    # The refit's and the repack's launches on the main path.
    refit_counters = ((tscene, "REFIT_LAUNCHES"),
                      (tpacked, "REPACK_LAUNCHES"))
    refit_launches = {"refit": 0, "repack": 0}
    errs = {"any": 0.0, "mask": 0.0, "defer_uv": 0.0}

    def soup_of(tris):
        return (tris.reshape(-1, 3),
                np.arange(tris.shape[0] * 3).reshape(-1, 3))

    def on_card(tris):
        return torch.as_tensor(tris, device=dev)

    def on_cpu(obj):
        """A Scene or PackedScene with its tensors copied to the CPU."""
        return dataclasses.replace(obj, **{
            f.name: getattr(obj, f.name).cpu()
            for f in dataclasses.fields(obj)
            if isinstance(getattr(obj, f.name), torch.Tensor)})

    def zero_signs(got, want, what):
        """-> entries whose bits differ; fails unless each is a zero of
        the other sign (equal values)."""
        differ = got.view(torch.int32) != want.view(torch.int32)
        check(torch.equal(got[differ], want[differ])
              and bool((got[differ] == 0).all()),
              f"{what}: differs in more than the sign of a zero")
        return int(differ.sum())

    def refit_vs_plain(scene, packed, frame, what):
        """The card's refit and repack of `frame` against their plain
        versions on CPU copies -> (scene', packed', max abs error, zero
        signs): bit for bit, but for the sign of a node's zero bound
        (csrc/refit.cu keeps the leftmost of a -0.0 / +0.0 tie in a leaf
        range, the plain range table's vectorised minima may take
        another), counted."""
        got = rt.refit(scene, frame)
        got_p = repack_bounds(packed, got)
        want = tscene.refit_reference(on_cpu(scene), frame.cpu())
        want_p = tpacked.repack_reference(on_cpu(packed), want)
        err, signs = 0.0, 0
        for f in SCENE_BOXES:
            g, w = getattr(got, f).cpu(), getattr(want, f)
            if f in NODE_BOXES:
                signs += zero_signs(g, w, f"{what}: refit {f}")
            else:
                check(bits_equal(g, w), f"{what}: refit {f} differs")
            err = max(err, float((g - w).abs().max()))
        tables_equal(on_cpu(got_p), want_p, f"{what}: repack",
                     ("tris", "tri_v"))
        signs += zero_signs(got_p.nodes.cpu().view(torch.float32),
                            want_p.nodes.view(torch.float32),
                            f"{what}: repack nodes")
        return got, got_p, err, signs

    def fresh_tables(frame, tri_mask=None):
        return pack_scene(rt.build_from_soup(frame, config=cfg, device=dev),
                          tri_mask=tri_mask)

    def host_ms(fn):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        return out, (time.perf_counter() - t0) * 1e3

    def drive(n, width, n_clip, on_device):
        """One size's main path and checks -> (record, state)."""
        g0 = scenes.deforming_grid(0.0, n=n)
        t = g0.shape[0]
        mask = np.where(np.arange(t) % 2 == 1, 1, 2).astype(np.uint32)
        tracer, lbvh_ms = host_ms(lambda: rt.Tracer(rt.build_from_soup(
            g0, config=cfg, device=dev), tri_mask=mask))
        (scene, packed), pack_ms = host_ms(lambda: (tracer.scene,
                                                    tracer.packed))
        lbvh_ms += pack_ms
        (sah, aux), sah_ms = host_ms(lambda: rt.build_sah_packed(
            soup_of(g0), rt.BuildConfig(leaf_size=16), step_quant=True,
            refittable=True, device=dev))
        cam = scenes.camera_rays(**GRID_CAM, width=width, height=width,
                                 order="morton", device=dev,
                                 on_device=on_device)
        clip = torch.stack([on_card(scenes.deforming_grid(0.05 * i, n=n))
                            for i in range(1, n_clip + 1)])
        singles = (1, 3, 5)  # the clip's frames at t = 0.1, 0.2, 0.3
        tables = {"lbvh8": (packed, scene), "sahq16": (sah, aux)}

        # ---- the main path: counts zeroed just before, read after ----
        sync()
        for c in counters:
            setattr(pt, c, 0)
        for mod, c in refit_counters:
            setattr(mod, c, 0)
        launch_log.start(8)
        one = {name: [pt.trace_packets_refit(p, s, clip[i], cam,
                                             sort_rays=False, **flags)
                      for i in singles] for name, (p, s) in tables.items()}
        many = {name: pt.trace_packets_refit_frames(p, s, clip, cam,
                                                    sort_rays=True, **flags)
                for name, (p, s) in tables.items()}
        moved = tracer.refresh(rt.refit(scene, clip[singles[0]]))
        h_mask = moved.closest(cam, filter_mask=1)
        h_any = moved.any(cam)
        sync()
        launch_log.stop()
        for c in counters:
            launches[c] += getattr(pt, c)
        for name, (mod, c) in zip(refit_launches, refit_counters):
            refit_launches[name] += getattr(mod, c)
        rec = {"tris": t, "rays": cam.count, "clip_frames": n_clip,
               "lbvh_build_pack_ms": lbvh_ms, "sah_build_pack_ms": sah_ms,
               "depth": {k: p.depth for k, (p, _) in tables.items()},
               "hits": [int(h.hit.sum()) for h, _, _ in one["lbvh8"]]}
        for name, hs in many.items():
            check(len(hs) == n_clip, f"{name}: {len(hs)} clip frames")
            for h in hs:
                check(bool(torch.isfinite(h.t[h.hit]).all()) and h.uv_deferred,
                      f"{name}: clip frame record")

        # The refit and the repack against their plain versions, on a
        # frame and on the built soup; refit to the built soup gives back
        # the built tables, the sign of a zero bound aside (the build's
        # eager reductions on the card pair -0.0 and +0.0 their own way).
        _, _, err, signs = refit_vs_plain(scene, packed, clip[singles[1]],
                                          "refit frame")
        same, same_p, err2, signs2 = refit_vs_plain(
            scene, packed, on_card(g0), "refit(same soup)")
        rec["refit_max_abs_err"] = max(err, err2)
        rec["refit_zero_signs_vs_plain"] = {"frame": signs,
                                            "same_soup": signs2}
        rec["refit_zero_signs_vs_build"] = sum(
            zero_signs(getattr(same, f), getattr(scene, f),
                       f"refit(same soup): {f}")
            for f in SCENE_BOXES if f != "tri_v")
        check(bits_equal(same.tri_v, scene.tri_v), "refit(same soup): tri_v")
        rec["repack_zero_signs_vs_build"] = zero_signs(
            same_p.nodes.view(torch.float32),
            packed.nodes.view(torch.float32), "repack(same soup): nodes")
        tables_equal(same_p, packed, "repack(same)", ("tris", "tri_v"))
        tables_equal(refit_packed_binary(sah, aux, g0), sah,
                     "refit_packed_binary(same)")
        del same, same_p

        # Every frame against a fresh build of its soup; the front-ends
        # against each other and against the separate steps.
        fresh_ms, max_t = [], 0.0
        for f in range(n_clip):
            fp, ms = host_ms(lambda: fresh_tables(clip[f]))
            fresh_ms.append(ms)
            fresh = pt.trace_packets(fp, cam)
            for name, (p, s) in tables.items():
                what = f"{name} frame {f}"
                max_t = max(max_t, refit_vs_fresh(many[name][f], fresh, what))
                again, _, _ = pt.trace_packets_refit(p, s, clip[f], cam,
                                                     sort_rays=True, **flags)
                same_hits(many[name][f], again, f"{what}: clip vs single")
            del fp, fresh
        for k, i in enumerate(singles):
            for name, (p, s) in tables.items():
                got, _, p2 = one[name][k]
                same_hits(got, many[name][i], f"{name} single {i} vs clip")
                if name == "lbvh8":
                    sep = repack_bounds(p, rt.refit(s, clip[i]))
                else:
                    sep = refit_packed_binary(p, s, clip[i])
                tables_equal(p2, sep, f"{name} single {i}: fused tables")
                same_hits(got, pt.trace_packets(sep, cam, sort_rays=False,
                                                **flags),
                          f"{name} single {i}: fused vs separate")
        # A refreshed masked Tracer against a fresh masked one.
        fresh_tr = rt.Tracer(rt.build_from_soup(clip[singles[0]], config=cfg,
                                                device=dev), tri_mask=mask)
        max_t = max(max_t, refit_vs_fresh(
            h_mask, fresh_tr.closest(cam, filter_mask=1), "refresh, mask 1"))
        refit_vs_fresh(moved.closest(cam, filter_mask=2),
                       fresh_tr.closest(cam, filter_mask=2),
                       "refresh, mask 2")
        check(torch.equal(h_any.hit, fresh_tr.any(cam).hit),
              "refresh: any-hit mask")
        check(int(h_mask.hit.sum()) > 0, "refresh: the mask filter hit nothing")
        rec.update(fresh_build_pack_ms=fresh_ms, max_t_err_vs_fresh=max_t,
                   mask1_hits=int(h_mask.hit.sum()))
        del fresh_tr, one, many
        return rec, SimpleNamespace(g0=g0, mask=mask, scene=scene,
                                    packed=packed, sah=sah, aux=aux, cam=cam,
                                    clip=clip, singles=singles, moved=moved,
                                    tables=tables)

    def frame_times(st, reps):
        """Per-frame ms of each stage, steady state with CUDA events; the
        refit's and the repack's rows (prefit.refit_rows: launches, the
        card's ms alone beside the plain versions', the byte bound)."""
        f = st.clip[st.singles[1]]
        rows = rows_of(st.cam)
        out = {}
        sc2, out["refit_ms"] = timed(lambda: rt.refit(st.scene, f), reps=reps)
        p2, out["repack_ms"] = timed(lambda: repack_bounds(st.packed, sc2),
                                     reps=reps)
        out["refit_rows"] = prefit.refit_rows({
            "refit": lambda: rt.refit(st.scene, f),
            "repack": lambda: repack_bounds(st.packed, sc2),
            "refit_plain": lambda: tscene.refit_reference(st.scene, f),
            "repack_plain": lambda: tpacked.repack_reference(st.packed, sc2),
        }, sc2, p2)
        _, out["kernel_ms"] = timed(lambda: pt.packet_trace_kernel(
            p2.nodes, p2.tris, rows, leaf_size=p2.leaf_size,
            stack_size=p2.stack_size, defer_uv=True), reps=reps)
        _, out["frame_ms"] = timed(lambda: pt.trace_packets_refit(
            st.packed, st.scene, f, st.cam, sort_rays=False, **flags)[0],
            reps=reps)
        s2, out["sah_refit_ms"] = timed(lambda: refit_packed_binary(
            st.sah, st.aux, f), reps=reps)
        _, out["sah_kernel_ms"] = timed(lambda: pt.packet_trace_kernel(
            s2.nodes, s2.tris, rows, leaf_size=s2.leaf_size,
            stack_size=s2.stack_size, defer_uv=True), reps=reps)
        _, out["sah_frame_ms"] = timed(lambda: pt.trace_packets_refit(
            st.sah, st.aux, f, st.cam, sort_rays=False, **flags)[0],
            reps=reps)
        for name, (p, s) in st.tables.items():
            hs, ms = timed(lambda: pt.trace_packets_refit_frames(
                p, s, st.clip, st.cam, sort_rays=True, **flags), reps=2)
            float(hs[-1].t[:1].sum())  # a real readback of the last frame
            out[f"clip_{name}_ms_per_frame"] = ms / st.clip.shape[0]
        return out, p2, rows

    # ---- 8a: BASELINE config 4 ----
    rec_a, a = drive(*small, on_device=False)
    times_a, p2, rows = frame_times(a, reps=6)
    rec_a["steady"] = times_a
    # The bound of the defer_uv launch timed above, from its own counts.
    rec_a["defer_uv_bound_ms"], rec_a["defer_uv_bound_by"] = bound(
        pt.packet_trace_kernel(p2.nodes, p2.tris, rows,
                               leaf_size=p2.leaf_size,
                               stack_size=p2.stack_size, defer_uv=True,
                               stats=True)[4], p2, 40)
    # The kernel against its plain version on refit tables, each variant
    # of this path, 8 and 16 wide.
    s2 = refit_packed_binary(a.sah, a.aux, a.clip[3])
    tree = NativeOracle(a.g0.reshape(-1, 9), leaf_max=16,
                        step_quant=True).export_tree()
    w16, aux16 = pack_binary_tree(a.g0, *tree, leaf_size=16, branching=16,
                                  return_refit_aux=True, device=dev)
    s16 = refit_packed_binary(w16, aux16, a.clip[3])
    mism = width_mismatch(pt.trace_packets(s16, a.cam),
                          pt.trace_packets(s2, a.cam))
    check(mism <= WIDTH_MISMATCH * a.cam.count,
          f"refit 16- vs 8-wide: {mism} rays disagree")
    rec_a["w16_refit_mismatch"] = mism
    for name, tab in (("lbvh8", p2), ("sahq16", s2), ("sahq16_w16", s16)):
        for var, kw in (("defer_uv", dict(defer_uv=True)),
                        ("any", dict(mode="any")),
                        ("mask", dict(filter_mask=1)), ("closest", {})):
            err = compare(pt.trace_packets(tab, a.cam, **kw),
                          pt.trace_packets_reference(tab, a.cam, **kw),
                          f"8a {name} {var} kernel/plain")
            check(err == 0.0, f"8a {name} {var}: kernel - plain {err}")
            errs[var] = max(errs.get(var, 0.0), err)
    del s2, s16, w16, aux16
    # A refreshed march Tracer (the grid is rebuilt) at phase 7's bar.
    wide = rt.build_from_soup(a.g0, config=rt.BuildConfig(leaf_size=8),
                              device=dev)
    march = rt.Tracer(wide, engine="march")
    march.closest(a.cam)
    check(march._grid is not None, "march tracer built no grid")
    moved = march.refresh(rt.refit(wide, a.clip[3]))
    check(moved._grid is None and moved._packed is not None,
          "refresh must drop the grid and keep the tables")
    before = pt.MARCH_LAUNCHES
    hm = moved.closest(a.cam)
    check(pt.MARCH_LAUNCHES == before + 1, "refreshed march never launched")
    rec_a["march_refresh_max_t_err_ties"] = march_parity(
        hm, rt.Tracer(moved.scene).closest(a.cam), "refreshed march")
    del wide, march, moved, hm
    # The card's idle share over the 32-frame clip, and the host's time to
    # enqueue it beside the time the card takes.
    p, s = a.tables["sahq16"]
    rec_a["clip_profile"] = profile_clip(lambda: pt.trace_packets_refit_frames(
        p, s, a.clip, a.cam, sort_rays=True, **flags), a.clip.shape[0], pt)
    del p2, rows

    # ---- 8b: the same path at 2.1M triangles and 2048^2 rays ----
    a = None
    torch.cuda.empty_cache()
    launch_log.reset_peak()
    rec_b, b = drive(*big, on_device=True)
    times_b, p2, rows = frame_times(b, reps=5)
    rec_b["steady"] = times_b
    # trace_packets_chunked against trace_packets, on refit tables.
    same_hits(pt.trace_packets_chunked(p2, b.cam, chunk=1 << 20),
              pt.trace_packets(p2, b.cam), "chunked vs whole")
    # Each variant of this path alone against its plain version on the
    # refit tables at this size, with the bound of its own pops (40 bytes
    # a ray where u and v are not written).
    kw = dict(leaf_size=p2.leaf_size, stack_size=p2.stack_size)
    entries = {}
    for var, extra, per_ray in (("any", dict(mode="any"), 48),
                                ("mask", dict(qmask=1), 48),
                                ("defer_uv", dict(defer_uv=True), 40)):
        k_out, k_ms = kernel_alone(pt, p2, rows, **extra)
        p_out, p_ms = timed(lambda: pt.packet_trace_reference(
            p2.nodes, p2.tris, rows, **kw, **extra), warm=False)
        err = compare(as_hits(k_out), as_hits(p_out), f"8b {var} kernel/plain")
        counts = pt.packet_trace_kernel(p2.nodes, p2.tris, rows, **kw,
                                        **extra, stats=True)[4]
        b_ms, b_by = bound(counts, p2, per_ray)
        entries[f"packet_trace_{var}"] = {
            "launches": launches[f"{var.upper()}_LAUNCHES"],
            "max_abs_err": max(err, errs[var]), "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": b_ms, "bound_by": b_by,
            "shape": f"{rec_b['tris']} refit triangles, {b.cam.count} rays"}
        if var == "defer_uv":
            rec_b["per_ray_mean"] = per_ray_mean(counts)
        del k_out, p_out, counts
    rec_b["peak_gib"] = launch_log.peak_gib()
    # The refit's and the repack's rows of the kernels line: the card's ms
    # alone at 8b (ms_config4: at 8a) beside the bound, and the issue
    # rate (issue_ms) beside the plain version's (plain_ms).
    for name in refit_launches:
        ra, rb = (r["steady"]["refit_rows"][name] for r in (rec_a, rec_b))
        want = 2 if name == "refit" else 1  # no wide node arrays
        check(ra["launches"] == rb["launches"] == want,
              f"{name}: {ra['launches']}, {rb['launches']} launches a "
              f"frame, not {want}")
        entries[name] = {
            "launches": refit_launches[name],
            "launches_a_frame": rb["launches"],
            "max_abs_err": max(rec_a["refit_max_abs_err"],
                               rec_b["refit_max_abs_err"]),
            "ms": rb["card_ms"], "ms_config4": ra["card_ms"],
            "issue_ms": rb["issue_ms"], "issue_ms_config4": ra["issue_ms"],
            "plain_ms": rb["plain_ms"], "plain_ms_config4": ra["plain_ms"],
            "bound_ms": rb["bound_ms"], "bound_ms_config4": ra["bound_ms"],
            "bound_by": "bytes", "bytes": rb["bytes"],
            "bytes_config4": ra["bytes"],
            "shape": f"8b's {rec_b['tris']} triangles (config4: 8a's "
                     f"{rec_a['tris']}), LBVH leaf 8 without wide arrays"}
    return ({"8a": rec_a, "8b": rec_b,
             "launches": {k.split("_LAUNCHES")[0].lower(): v
                          for k, v in launches.items()}}, entries)

def wavefront4(rt, ps, rays, box, seed, caps=None, collect=None, log=None):
    """bench.py:833-874 on the port: the primaries and three bounces
    through trace_closest_instanced_packets; every bounce batch keeps the
    full shape, live rays compacted to the front in Morton order, the dead
    tail at max_t = 0.  box: the (lo, hi) of the sort key.  collect
    gathers each trace's per-round live counts (they size the pooled
    caps); log gathers (batch, hits, instance ids, trace stats, start and
    end event).
    -> (rays traced, last hits)."""
    from rtk_tpu_torch.models.path import (_ray_sort_key, cosine_sample,
                                           geometric_normal)

    dev = rays.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    kw = dict(max_candidates=INST_CANDIDATES, leaf_loop=True, ordered=True,
              p_pk=16)
    if caps is not None:
        kw["round_caps"] = caps
    m = rays.count

    def trace(rb):
        st = {}
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        out = rt.trace_closest_instanced_packets(
            ps, rb, return_live_counts=collect is not None, stats=st, **kw)
        ev[1].record()
        if collect is not None:
            collect.append(out[2].numpy())
        if log is not None:
            log.append((rb, out[0], out[1], st, *ev))
        return out[0]

    rays_b, total = rays, m
    hits = trace(rays_b)
    for _ in range(3):
        nrm = geometric_normal(hits, rays_b.direction)
        nd = cosine_sample(gen, nrm)
        origin = hits.position() + WAVE_EPS * nrm
        key = _ray_sort_key(rt.Rays(origin, nd, rays_b.min_t, rays_b.max_t),
                            *box)
        order = ((~hits.hit).to(torch.int32) << 28) | (key >> 4)
        perm = torch.sort(order, stable=True).indices
        n_alive = int(hits.hit.sum())  # one host sync a bounce
        if n_alive == 0:
            break
        live = torch.arange(m, device=dev) < n_alive
        rays_b = rt.Rays(origin[perm], nd[perm],
                         torch.full((m,), WAVE_EPS, device=dev),
                         torch.where(live, float(np.float32(3.4e38)), 0.0))
        hits = trace(rays_b)
        total += n_alive
    float(hits.t[:1].sum())  # a real readback
    return total, hits


class BounceLog:
    """Stands where the render functions take a Tracer: passes each
    closest() and any() on and keeps the batches: per closest() the batch,
    its live rays (a device count, read later) and CUDA events around the
    trace; per any() the batch."""

    def __init__(self, tracer, bounce_tracer=None):
        self.tracers = (tracer, bounce_tracer or tracer)
        self.scene = tracer.scene
        self.batches, self.live, self.events = [], [], []
        self.any_batches = []

    def any(self, rays, **kw):
        self.any_batches.append(rays)
        return self.tracers[0].any(rays, **kw)

    def closest(self, rays, **kw):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        hits = self.tracers[bool(self.batches)].closest(rays, **kw)
        ev[1].record()
        self.batches.append(rays)
        self.live.append((rays.max_t > rays.min_t).sum())
        self.events.append(ev)
        return hits

    def per_bounce(self, end):
        """[{launched, live, trace_ms, shade_ms}]: shade_ms runs from the
        end of a trace to the start of the next (shade, sample, key, sort,
        take), or to `end` after the last."""
        starts = [e[0] for e in self.events[1:]] + [end]
        return [{"launched": b.count, "live": int(n),
                 "trace_ms": e[0].elapsed_time(e[1]),
                 "shade_sort_take_ms": e[1].elapsed_time(nxt)}
                for b, n, e, nxt in zip(self.batches, self.live, self.events,
                                        starts)]


def shade_vs_plain(path, tracer, cam, mats, uniforms, bounces, background):
    """The shade kernel (models/path.py::shade_kernel) on each batch of a
    compacted, sorted frame with the uniforms handed in, against the eager
    plain pass (_shade_sample, its uniforms' gather included) on the same
    inputs: every output bit-equal; each one's ms (the kernel over 20
    launches, the plain pass over 3, on a scratch radiance) beside the
    kernel's bound.  -> {"per_bounce": [...], "ms", "plain_ms",
    "bound_ms" (the bounce batches' means), "max_abs_err"}."""
    dev = cam.device
    n = cam.count
    bg = torch.tensor(background, dtype=torch.float32, device=dev)
    lo, hi = tracer.scene.bounds_min, tracer.scene.bounds_max
    radiance = torch.zeros((n, 3), device=dev)
    throughput = torch.ones((n, 3), device=dev)
    index = torch.arange(n, device=dev)
    cur = cam
    per = []
    for bounce in range(bounces + 1):
        hits = tracer.closest(cur)
        last = bounce == bounces
        kw = dict(epsilon=1e-4, sort_rays=True, last=last)
        draws = didx = None
        if not last:
            draws, didx = uniforms[bounce], index

        def kernel(rad):
            return path.shade_kernel(hits, cur, throughput, index, rad, mats,
                                     bg, lo, hi, draws=draws,
                                     draw_index=didx, **kw)

        def plain(rad):
            return path._shade_plain(hits, cur, throughput, index, rad, mats,
                                     None, bg, lo, hi, uniforms=uniforms,
                                     bounce=bounce, **kw)

        scratch = radiance.clone()
        _, k_ms = timed(lambda: kernel(scratch), reps=20)
        _, p_ms = timed(lambda: plain(scratch), reps=3)
        got = kernel(radiance.clone())
        want = plain(radiance)
        per_bytes = SHADE_LAST_BYTES_PER_RAY if last else SHADE_BYTES_PER_RAY
        row = {"bounce": bounce, "rays": cur.count, "ms": k_ms,
               "plain_ms": p_ms,
               "bound_ms": per_bytes * cur.count / PEAK_BYTES * 1e3}
        if last:
            check(bits_equal(got, want), "9a shade: last radiance differs")
            per.append(row)
            break
        radiance, nxt, throughput_w, perm, alive = want
        same = (bits_equal(got[0], radiance)
                and all(bits_equal(getattr(got[1], f), getattr(nxt, f))
                        for f in ("origin", "direction", "min_t", "max_t"))
                and bits_equal(got[2], throughput_w)
                and torch.equal(torch.sort(got[3], stable=True).indices, perm)
                and int(got[4]) == int(alive))
        check(same, f"9a shade bounce {bounce}: kernel and plain differ")
        row["live"] = int(alive)
        per.append(row)
        m = min(cur.count, path._round_up_bucket(int(alive), 1024))
        cur, throughput, index = path._compact_take(nxt, throughput_w, index,
                                                    perm, m=m)
    mid = per[:-1]
    return {"per_bounce": per, "max_abs_err": 0.0,
            "ms": sum(r["ms"] for r in mid) / len(mid),
            "plain_ms": sum(r["plain_ms"] for r in mid) / len(mid),
            "bound_ms": sum(r["bound_ms"] for r in mid) / len(mid),
            "frame_ms": sum(r["ms"] for r in per),
            "frame_plain_ms": sum(r["plain_ms"] for r in per)}


def host_syncs(run):
    """Synchronizing calls PyTorch makes on the host while run() runs."""
    import warnings

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            run()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in caught)


def slab_alone(instancing, iscene, rays, c, reps=20):
    """The instance candidate slab's kernel (candidates_kernel) alone on a
    batch (a camera's expanded origin made contiguous first, as
    _instance_candidates does), back to back, beside its bound and the
    plain slab (_instance_candidates_impl) on the same CUDA tensors, whose
    three outputs it must equal bit for bit -> {"kernel_ms", "bound_ms",
    "binds", "plain_ms"}."""
    lo, hi = iscene.inst_lo, iscene.inst_hi
    rays = type(rays)(*(a.contiguous() for a in (
        rays.origin, rays.direction, rays.min_t, rays.max_t)))
    got, ms = timed(lambda: instancing.candidates_kernel(lo, hi, rays, c),
                    reps=reps)
    want, plain_ms = timed(lambda: instancing._instance_candidates_impl(
        lo, hi, rays, c), reps=2)
    for g, w, name in zip(got, want, ("cand_idx", "cand_t", "overflow")):
        check(bits_equal(g, w), f"candidate slab kernel/plain: {name}")
    n, n_box = rays.count, lo.shape[0]
    t_ops = n * n_box * SLAB_OPS_PER_TEST / PEAK_F32_INSTR * 1e3
    t_bytes = (n * (SLAB_READ_BYTES_PER_RAY + 8 * min(c, n_box) + 4)
               / PEAK_BYTES * 1e3)
    return {"kernel_ms": ms, "bound_ms": max(t_ops, t_bytes),
            "binds": "operations" if t_ops >= t_bytes else "bytes",
            "plain_ms": plain_ms}


def round_glue_alone(instancing, pt, ps, rays, c, reps=20):
    """An instanced round's glue alone at a batch of every ray of `rays`
    (1,048,576 at config 5), in a round's order: each ray's nearest
    candidate instance (instance i mod I where it has none), sorted by
    instance.  The kernels (round_rays_kernel, then round_scatter_kernel
    on that batch's own rooted trace) back to back beside their byte
    bound and the eager glue (round_rays_reference,
    round_scatter_reference) on the same CUDA tensors, whose outputs they
    must equal bit for bit -> {"rows", "rays_ms", "rays_plain_ms",
    "rays_bound_ms", "scatter_ms", "scatter_plain_ms", "scatter_bound_ms",
    "better"}."""
    iscene = ps.iscene
    n, dev = rays.count, rays.origin.device
    world = tuple(a.contiguous() for a in (rays.origin, rays.direction,
                                           rays.min_t))
    cand = instancing._instance_candidates(iscene, rays, c)[0][:, 0].long()
    cand = torch.where(cand >= 0, cand, torch.arange(n, device=dev)
                       % iscene.num_instances)
    inst, rows = torch.sort(cand, stable=True)
    best_t = rays.max_t.contiguous().clone()
    args = (rows, inst, *world, best_t, iscene.object_from_world,
            iscene.instance_blas, ps.packed_roots)
    got, rays_ms = timed(lambda: instancing.round_rays_kernel(*args),
                         reps=reps)
    want, rays_plain_ms = timed(
        lambda: instancing.round_rays_reference(*args), reps=reps)
    for name in ("origin", "direction", "min_t", "max_t"):
        check(bits_equal(getattr(got[0], name), getattr(want[0], name)),
              f"9c round rays kernel/plain: {name}")
    check(torch.equal(got[1], want[1])
          and torch.equal(got[2], want[2].to(torch.int32)),
          "9c round rays kernel/plain: roots or instance")
    h = pt._trace_rooted(pt.CARD, ps.packed, got[0], got[1])
    sargs = (rows, h.hit, h.t, h.u, h.v, h.slot, got[0].max_t, got[2])

    def fresh():
        return {"t": best_t.clone(), "u": torch.zeros_like(best_t),
                "v": torch.zeros_like(best_t),
                "slot": torch.full((n,), -1, dtype=torch.int32, device=dev),
                "inst": torch.full((n,), -1, dtype=torch.int32, device=dev)}

    # Writing a round's better hits again writes the same bits, so the
    # back-to-back calls time the scatter at its own batch.
    best_k, best_p = fresh(), fresh()
    scatter_ms = timed(lambda: instancing.round_scatter_kernel(
        *sargs, best_k), reps=reps)[1]
    scatter_plain_ms = timed(lambda: instancing.round_scatter_reference(
        *sargs, best_p), reps=reps)[1]
    for k in best_k:
        check(bits_equal(best_k[k], best_p[k]),
              f"9c round scatter kernel/plain: {k}")
    better = int((best_k["slot"] >= 0).sum())
    return {"rows": n, "rays_ms": rays_ms, "rays_plain_ms": rays_plain_ms,
            "rays_bound_ms": n * ROUND_RAYS_BYTES / PEAK_BYTES * 1e3,
            "scatter_ms": scatter_ms, "scatter_plain_ms": scatter_plain_ms,
            "scatter_bound_ms": (n * ROUND_SCATTER_BYTES
                                 + better * ROUND_SCATTER_BETTER_BYTES)
            / PEAK_BYTES * 1e3, "better": better}


def phase9(rt, dev, launch_log, inst, width=1024, bounces=4,
           direct_sub=128, ao_samples=8):
    """The render path: render_path, render_direct and render_ao on the
    atrium (9a, 9b) and the 4-bounce instanced wavefront on config 5 (9c,
    on phase 5's tables).  Returns its three records, the launches of its
    main-path runs by counter (counts are zeroed just before each
    main-path run and read just after) and the largest |kernel - plain|
    per kernel over the batches those runs launched."""
    from rtk_tpu_torch import instancing
    from rtk_tpu_torch.models import path
    from rtk_tpu_torch.ops import packet_trace as pt
    from rtk_tpu_torch.ops.morton import ray_coherence_key
    from rtk_tpu_torch.testing import scenes

    sync = torch.cuda.synchronize
    counters = ("KERNEL_LAUNCHES", "ANY_LAUNCHES", "STATS_LAUNCHES",
                "DEFER_UV_LAUNCHES", "MARCH_LAUNCHES", "ROOTS_LAUNCHES")
    launches = dict.fromkeys(counters, 0)

    launches["SHADE_LAUNCHES"] = 0

    def counted(fn):
        """fn() as a main-path run -> (its result, its launches, the shade
        kernel's (models/path.py's SHADE_LAUNCHES) among them)."""
        sync()
        for c in counters:
            setattr(pt, c, 0)
        path.SHADE_LAUNCHES = 0
        launch_log.start(9)
        out = fn()
        sync()
        launch_log.stop()
        got = {c: getattr(pt, c) for c in counters}
        got["SHADE_LAUNCHES"] = path.SHADE_LAUNCHES
        for c in got:
            launches[c] += got[c]
        return out, got

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    # ---- 9a: render_path on the atrium ----
    atr = scenes.atrium()
    check(atr.shape[0] == sum(ATRIUM_PARTS), "atrium parts")
    cuts = np.cumsum((0,) + ATRIUM_PARTS)
    meshes = [(atr[a:b].reshape(-1, 3),
               np.arange((b - a) * 3).reshape(-1, 3))
              for a, b in zip(cuts[:-1], cuts[1:])]
    sync()
    t0 = time.perf_counter()
    scene = rt.build_scene(meshes, rt.BuildConfig(leaf_size=16), device=dev)
    tracer = rt.Tracer(scene)
    packed = tracer.packed
    sync()
    build_s = time.perf_counter() - t0
    mats = path.Materials.make(ATRIUM_ALBEDO, ATRIUM_EMISSION, device=dev)
    cam = scenes.camera_rays(**ATRIUM_CAM, width=width, height=width,
                             order="morton", device=dev)
    n = cam.count
    kw = dict(bounces=bounces, background=(0.2, 0.3, 0.4))

    def run_logged(seed=1, bounce_tracer=None, tr=tracer, **over):
        log = BounceLog(tr, bounce_tracer)
        end = torch.cuda.Event(enable_timing=True)
        rad = path.render_path(log, cam, mats, gen(seed), **{**kw, **over})
        end.record()
        sync()
        return rad, log, end

    run_logged()  # warm-up
    (rad, log, end), got = counted(run_logged)
    check(got["KERNEL_LAUNCHES"] == len(log.batches) == bounces + 1
          == got["SHADE_LAUNCHES"],
          f"9a: {got['KERNEL_LAUNCHES']} kernel and "
          f"{got['SHADE_LAUNCHES']} shade launches for "
          f"{len(log.batches)} traces")
    check(rad.shape == (n, 3) and bool(torch.isfinite(rad).all())
          and bool((rad >= 0).all()) and float(rad.max()) > 0.01,
          "9a: radiance not finite, non-negative and lit")
    rows = log.per_bounce(end)
    for r, before in zip(rows, EAGER_SHADE_SORT_TAKE_MS):
        r["eager_shade_sort_take_ms"] = before
    check(all(a["live"] >= b["live"] for a, b in zip(rows, rows[1:]))
          and rows[-1]["live"] < rows[0]["live"],
          "9a: the bounce batches do not shrink")
    total = sum(r["live"] for r in rows)

    # The draws handed in by ray and bounce (render_path's uniforms): one
    # radiance, bit for bit, with compaction and the sort on or off; the
    # render loop's counters beside the launches they stand for.
    uniforms = torch.rand((bounces, n, 2), generator=gen(5), device=dev)
    names = ("PATH_TRACES", "PATH_ROWS", "PATH_SYNCS")
    for c in names:
        setattr(path, c, 0)
    (rad_u, log_u, _), got_u = counted(lambda: run_logged(uniforms=uniforms))
    path_counts = {c: getattr(path, c) for c in names}
    path_counts["SHADE_LAUNCHES"] = got_u["SHADE_LAUNCHES"]
    check(path_counts["PATH_TRACES"] == got_u["KERNEL_LAUNCHES"]
          == len(log_u.batches) == bounces + 1
          == path_counts["SHADE_LAUNCHES"],
          f"9a uniforms: {path_counts} for {got_u}")
    check(path_counts["PATH_ROWS"] == sum(b.count for b in log_u.batches)
          and path_counts["PATH_SYNCS"] == bounces,
          f"9a uniforms: {path_counts} for batches "
          f"{[b.count for b in log_u.batches]}")
    differ = {}
    for name, over in (("no_compact", dict(compact=False)),
                       ("no_sort", dict(sort_rays=False)),
                       ("neither", dict(compact=False, sort_rays=False))):
        other = run_logged(uniforms=uniforms, **over)[0]
        differ[name] = int((other != rad_u).any(dim=1).sum())
    check(not any(differ.values()),
          f"9a uniforms: rays whose radiance differs from the compacted "
          f"sorted call's {differ}")
    rec_u = {"counters": path_counts, "launches": got_u,
             "launched": [b.count for b in log_u.batches],
             "rays_differing": differ, "mean_radiance": float(rad_u.mean())}
    # The shade kernel alone against the eager plain pass on each batch of
    # the same frame: every output bit for bit, ms beside the bound.
    rec_a_shade = shade_vs_plain(path, tracer, cam, mats, uniforms, bounces,
                                 kw["background"])
    del rad_u, log_u, uniforms
    # Per-ray counts of each bounce batch (the stats variant), the kernel
    # alone on the sorted rows the front end hands it, and its bound.
    counts, got_s = counted(lambda: [pt.trace_packets(packed, b, stats=True)[1]
                                     for b in log.batches])
    check(got_s["STATS_LAUNCHES"] == bounces + 1, "9a: stats launches")
    for r, b, c in zip(rows, log.batches, counts):
        order = torch.sort(ray_coherence_key(b.origin, b.direction),
                           stable=True).indices
        sorted_rows = rows_of(b)[:, order].contiguous()
        r["kernel_ms"] = kernel_alone(pt, packed, sorted_rows)[1]
        r["defer_uv_kernel_ms"] = kernel_alone(pt, packed, sorted_rows,
                                               defer_uv=True)[1]
        del sorted_rows
        r["bound_ms"], r["bound_by"] = bound(c, packed)
        r["per_ray_mean"] = per_ray_mean(c)
    del counts

    def whole(m=mats, **over):
        """Steady ms of one un-instrumented call (3 after a warm-up)."""
        return timed(lambda: path.render_path(tracer, cam, m, gen(1),
                                              **{**kw, **over}), reps=3)[1]

    ms = whole()
    rec_a = {"tris": scene.num_tris, "rays": n, "bounces": bounces,
             "build_pack_s": build_s, "depth": packed.depth,
             "per_bounce": rows, "total_rays": total, "ms": ms,
             "mrays_s": total / ms / 1e3, "launches": got,
             "mean_radiance": float(rad.mean()), "uniforms": rec_u,
             "shade": rec_a_shade}
    rec_a["host_syncs"] = host_syncs(lambda: path.render_path(
        tracer, cam, mats, gen(1), **kw))
    rec_a["profile"] = profile_clip(lambda: path.render_path(
        tracer, cam, mats, gen(1), **kw), bounces + 1, pt)
    # The same call without the sort, without compaction, and with an
    # exact-size take in place of the power-of-two bucket.
    for name, over in (("no_sort", dict(sort_rays=False)),
                       ("no_compact", dict(compact=False))):
        r2, l2, e2 = run_logged(**over)
        check(bool(torch.isfinite(r2).all()), f"9a {name}: radiance")
        rec_a[name] = {"ms": whole(**over), "per_bounce": l2.per_bounce(e2),
                       "mean_radiance": float(r2.mean())}
    rec_a["no_compact"]["host_syncs"] = host_syncs(lambda: path.render_path(
        tracer, cam, mats, gen(1), **kw, compact=False))
    # ... and all three again where the buckets do shrink: the floor
    # absorbs too, so fewer than half the rays outlive each bounce.
    dark = path.Materials.make(ATRIUM_DARK_ALBEDO, ATRIUM_EMISSION, device=dev)
    dlog = BounceLog(tracer)
    path.render_path(dlog, cam, dark, gen(1), **kw)
    rec_a["shrinking"] = {
        "launched": [b.count for b in dlog.batches],
        "live": [int(x) for x in dlog.live],
        "bucket_ms": whole(dark), "no_compact_ms": whole(dark, compact=False)}
    check(dlog.batches[-1].count < n, "9a: the dark floor shrank no bucket")
    del dlog
    bucket = path._round_up_bucket
    path._round_up_bucket = lambda live, minimum: live
    try:
        rec_a["exact_take_ms"] = whole()
        rec_a["shrinking"]["exact_take_ms"] = whole(dark)
    finally:
        path._round_up_bucket = bucket

    # The furnace identity: albedo 1, emission e and background e, so each
    # live ray traced adds exactly e and stays alive exactly when it hit.
    furnace = path.Materials.make(np.ones((4, 3)), np.full((4, 3), FURNACE_E),
                                  device=dev)
    rec_a["furnace"] = {}
    for compact in (True, False):
        flog = BounceLog(tracer)
        q = path.render_path(flog, cam, furnace, gen(2), bounces=bounces,
                             background=(FURNACE_E,) * 3,
                             compact=compact) / FURNACE_E
        traced = sum(int(x) for x in flog.live)
        what = f"9a furnace compact={compact}"
        check(torch.equal(q, q.round()) and int(q.min()) >= 1
              and int(q.max()) <= bounces + 1,
              f"{what}: radiance / e not whole in [1, {bounces + 1}]")
        check(bool((q == q[:, :1]).all()), f"{what}: channels differ")
        check(int(q[:, 0].sum().item()) == traced,
              f"{what}: sum {int(q[:, 0].sum())} != {traced} rays traced")
        rec_a["furnace"][f"compact_{compact}"] = {
            "rays_traced": traced, "sum_radiance_over_e": int(q[:, 0].sum()),
            "min": int(q.min()), "max": int(q.max())}

    # defer_uv changes no radiance (position() and the materials need no
    # u, v); the march as bounce_tracer against the flat engine.
    (rad_d, _, _), got_d = counted(lambda: run_logged(tr=rt.Tracer(
        scene, config=rt.TraceConfig(defer_uv=True))))
    check(got_d["DEFER_UV_LAUNCHES"] == bounces + 1, "9a: defer_uv launches")
    check(torch.equal(rad_d, rad), "9a: defer_uv changed the radiance")
    march = rt.Tracer(scene, engine="march")
    march.grid
    (rad_m, mlog, _), got_m = counted(lambda: run_logged(
        bounce_tracer=march))
    check(got_m["MARCH_LAUNCHES"] == bounces, "9a: march launches")
    # The march kernel alone on each bounce batch it was handed, beside
    # its bound: the run's launches as the log replayed them.
    rec_a["march_kernel"] = [
        {"bounce": i, **{k: r[k] for k in ("rays", "ms", "bound_ms",
                                           "bound_by")}}
        for i, r in enumerate((x for x in launch_log.last
                               if x["flags"]["march"]), 1)]
    share = float(((rad_m - rad).abs() <= 1e-4).all(dim=1).float().mean())
    check(share >= ENGINE_SHARE, f"9a: march bounces agree on {share}")
    del mlog
    rec_a.update(defer_uv_equal=True, march_agree_share=share,
                 march_ms=timed(lambda: path.render_path(
                     tracer, cam, mats, gen(1), **kw, bounce_tracer=march),
                     reps=3)[1])
    del march, rad_d, rad_m

    # The kernel against its plain version on the very batches the call
    # above launched: every bounce batch for closest, bounce 2's for any.
    errs = {"kernel": 0.0, "any": 0.0, "roots": 0.0}

    def vs_plain(batch, mode, what):
        """trace_packets on the card against trace_packets_reference on
        one whole batch; the difference must be 0.0."""
        got_k, k_ms = timed(lambda: pt.trace_packets(packed, batch, mode=mode),
                            warm=False)
        want, p_ms = timed(lambda: pt.trace_packets_reference(
            packed, batch, mode=mode), warm=False)
        err = compare(got_k, want, f"{what} {mode} kernel/plain")
        check(err == 0.0, f"{what} {mode}: kernel - plain {err}")
        key = "any" if mode == "any" else "kernel"
        errs[key] = max(errs[key], err)
        return {"rays": batch.count, "mode": mode, "max_abs_err": err,
                "ms": k_ms, "plain_ms": p_ms, "hits": int(got_k.hit.sum())}

    rec_a["kernel_vs_plain"] = (
        [{"bounce": i, **vs_plain(b, "closest", f"9a bounce {i}")}
         for i, b in enumerate(log.batches) if i > 0]
        + [{"bounce": 2, **vs_plain(log.batches[2], "any", "9a bounce 2")}])

    # ---- 9b: render_direct and render_ao on the same scene ----
    blog = BounceLog(tracer)
    img, got_b = counted(lambda: path.render_direct(blog, cam, mats,
                                                    **ATRIUM_LIGHT))
    # The any-hit kernel alone on the shadow rays and the first AO probe,
    # beside its bound: the runs' launches as the log replayed them.
    any_alone = {"shadow": [r for r in launch_log.last
                            if r["flags"]["any"]][0]}
    check(got_b["KERNEL_LAUNCHES"] == 2 and got_b["ANY_LAUNCHES"] == 1,
          f"9b direct launches {got_b}")
    ao_kw = dict(samples=ao_samples, max_dist=3.0)  # the room is 20 wide
    ao, got_ao = counted(lambda: path.render_ao(blog, cam, gen(3),
                                                **ao_kw))
    any_alone["ao_probe_0"] = [r for r in launch_log.last
                               if r["flags"]["any"]][0]
    any_alone = {k: {f: r[f] for f in ("rays", "ms", "bound_ms", "bound_by")}
                 for k, r in any_alone.items()}
    check(got_ao["KERNEL_LAUNCHES"] == ao_samples + 1
          and got_ao["ANY_LAUNCHES"] == ao_samples,
          f"9b ao launches {got_ao}")
    check(bool(torch.isfinite(img).all()) and float(img.max()) > 0.01,
          "9b: direct image")
    # A pixel is lit only if its shadow ray, made again here and traced
    # through the stack engine, is unoccluded.
    s_cam = cam[::max(1, n // direct_sub ** 2)]
    s_img = img[::max(1, n // direct_sub ** 2)]
    h = tracer.closest(s_cam)
    nrm = path.geometric_normal(h, s_cam.direction)
    pos = h.position() + 1e-4 * nrm
    lvec = torch.tensor(ATRIUM_LIGHT["light_pos"], device=dev)[None] - pos
    ldist = torch.linalg.vector_norm(lvec, dim=1)
    shadow = rt.Rays(pos, lvec / ldist[:, None].clamp_min(1e-20),
                     torch.full_like(ldist, 1e-4),
                     torch.where(h.hit, ldist * (1.0 - 1e-3), 0.0))
    t0 = time.perf_counter()
    occluded = rt.trace_any(scene, shadow).hit
    sync()
    stack_s = time.perf_counter() - t0
    emis = mats.emission[h.mesh_index.clamp(0, 3).long()]
    lit = ((s_img - emis).amax(dim=1) > 0) & h.hit
    check(int(lit.sum()) > 0 and int((h.hit & ~lit).sum()) > 0,
          "9b: the subset has no lit or no dark pixel")
    check(not bool((lit & occluded).any()),
          f"9b: {int((lit & occluded).sum())} lit pixels are occluded on "
          "the stack engine")
    check(bool((ao >= 0).all() and (ao <= 1).all())
          and torch.equal(ao * ao_samples, (ao * ao_samples).round())
          and not bool(ao[~tracer.closest(cam).hit].any())
          and 0.05 < float(ao.mean()) < 0.99, "9b: ambient occlusion")
    # The any-hit kernel against its plain version on the batches those
    # two calls launched: the shadow rays, the first and the last AO probe.
    check(len(blog.any_batches) == 1 + ao_samples, "9b: any-hit batches")
    any_vs_plain = [vs_plain(blog.any_batches[i], "any", f"9b {what}")
                    for i, what in ((0, "shadow rays"), (1, "ao probe 0"),
                                    (-1, f"ao probe {ao_samples - 1}"))]
    del blog
    d_ms = timed(lambda: path.render_direct(tracer, cam, mats, **ATRIUM_LIGHT),
                 reps=3)[1]
    ao_ms = timed(lambda: path.render_ao(tracer, cam, gen(3), **ao_kw),
                  reps=3)[1]
    rec_b = {"rays": n, "direct_ms": d_ms,
             "direct_mrays_s": 2 * n / d_ms / 1e3,
             "direct_launches": got_b, "direct_mean": float(img.mean()),
             "subset_rays": s_cam.count, "subset_lit": int(lit.sum()),
             "subset_occluded": int(occluded.sum()),
             "subset_stack_any_s": stack_s,
             "ao_samples": ao_samples, "ao_ms": ao_ms,
             "ao_mrays_s": (ao_samples + 1) * n / ao_ms / 1e3,
             "ao_mean": float(ao.mean()), "ao_launches": got_ao,
             "any_vs_plain": any_vs_plain, "any_kernel_alone": any_alone}
    del img, ao, log, tracer, scene, packed

    # ---- 9c: the 4-bounce instanced wavefront on config 5 ----
    tf = inst.tf
    box = (torch.tensor(tf[:, :, 3].min(axis=0) - 1.0, device=dev),
           torch.tensor(tf[:, :, 3].max(axis=0) + 2.0, device=dev))
    n_inst, rays = inst.iscene.num_instances, inst.rays
    rec_c = {"rays": rays.count, "instances": n_inst,
             "instanced_tris": inst.iscene.total_triangles}
    for name in ("sahq16", "lbvh8"):
        ps = inst.tables[name]
        col = []
        # The warm-up doubles as calibration (bench.py:878-883).
        total0, h0 = wavefront4(rt, ps, rays, box, 5, collect=col)
        caps = instancing.caps_from_counts(
            np.max(np.stack(col), axis=0), rays.count, n_inst, p_pk=16)
        wlog = []
        slabs = instancing.CANDIDATE_LAUNCHES
        glue = (instancing.ROUND_LAUNCHES, instancing.INSTANCED_ROUNDS)
        (total, h1), got_c = counted(lambda: wavefront4(
            rt, ps, rays, box, 5, caps=caps, log=wlog))
        slabs = instancing.CANDIDATE_LAUNCHES - slabs
        glue = (instancing.ROUND_LAUNCHES - glue[0],
                instancing.INSTANCED_ROUNDS - glue[1])
        # The rounds' glue: two launches of csrc/rounds.cu a round.
        check(glue[0] == 2 * glue[1] > 0,
              f"9c {name}: {glue[0]} round launches, {glue[1]} rounds")
        check(got_c["ROOTS_LAUNCHES"] > 0
              and got_c["ROOTS_LAUNCHES"] == got_c["KERNEL_LAUNCHES"],
              f"9c {name}: launches {got_c}")
        # One slab launch a trace, one more a residual that re-traced.
        check(slabs == len(wlog) + sum(st["residual"] > 0
                                       for *_, st, _, _ in wlog),
              f"9c {name}: {slabs} candidate slab launches")
        # Caps never change an exact answer.
        check(total == total0 and torch.equal(h1.t, h0.t)
              and torch.equal(h1.hit, h0.hit),
              f"9c {name}: capped run differs from the uncapped one")
        best = float("inf")
        for seed in (11, 12):  # bench.py:886-890
            sync()
            t0 = time.perf_counter()
            wavefront4(rt, ps, rays, box, seed, caps=caps)
            best = min(best, (time.perf_counter() - t0) * 1e3)
        per = []
        for rb, hits, ids, st, e0, e1 in wlog:
            what = f"9c {name} bounce {len(per)}"
            # The rounds (roots variant) against their plain version on
            # this very batch, capped as the run was: every batch on the
            # SAH forest; on the LBVH forest, where the plain version takes
            # twice as long, the first and the last bounce.
            plain_ms = err = None
            if name == "sahq16" or len(per) in (1, len(wlog) - 1):
                want, plain_ms = timed(
                    lambda: rt.trace_closest_instanced_packets(
                        ps, rb, max_candidates=INST_CANDIDATES,
                        round_caps=caps, plain=True), warm=False)
                err = compare(hits, want[0], f"{what} kernel/plain")
                check(err == 0.0 and torch.equal(ids, want[1]),
                      f"{what}: kernel - plain {err}, or the instance differs")
                errs["roots"] = max(errs["roots"], err)
                del want
            mism, t_share = check_vs_flat(hits, inst.flat.closest(rb), what)
            check(bool(torch.isfinite(hits.t[hits.hit]).all()),
                  f"{what}: non-finite t")
            slab_ms = timed(lambda: instancing._instance_candidates(
                inst.iscene, rb, INST_CANDIDATES), reps=2)[1]
            slab = slab_alone(instancing, inst.iscene, rb, INST_CANDIDATES)
            # Round 0's launch alone in the rounds' order, with each
            # instance's rows sorted by their object-space coherence key,
            # and in the batch's own order: does an ordering pay for
            # itself in the kernel?
            r0 = {}
            for how, kw_ in (("grouped", {}), ("keyed", {"keyed": True}),
                             ("world", {"grouped": False})):
                c0, q0, o_ms = round0(inst.iscene, ps, rb, **kw_)
                r0[f"{how}_kernel_ms"] = roots_alone(pt, ps.packed, c0,
                                                     q0)[1]
                r0[f"{how}_order_ms"] = o_ms
                r0["rays"] = c0.shape[1]
                del c0, q0
            trace_ms = e0.elapsed_time(e1)
            per.append({"live": int((rb.max_t > rb.min_t).sum()),
                        "hits": int(hits.hit.sum()),
                        "trace_ms": trace_ms, "candidate_slab_ms": slab_ms,
                        "slab_kernel": slab,
                        "rounds_ms": trace_ms - slab_ms,
                        "round_live_counts": st["live_counts"],
                        "round0": r0,
                        "residual": st["residual"],
                        "plain_ms": plain_ms, "max_abs_err": err,
                        "flat_hit_mismatch": mism, "flat_t_share": t_share})
        rec_c[name] = {"total_rays": total, "ms": best,
                       "mrays_s": total / best / 1e3, "caps": caps,
                       "launches": got_c, "candidate_launches": slabs,
                       "round_launches": glue[0], "per_bounce": per}
    # The rounds' glue alone at a whole 1024^2 batch (csrc/rounds.cu).
    rec_c["round_glue"] = round_glue_alone(
        instancing, pt, inst.tables["sahq16"], rays, INST_CANDIDATES)
    return ({"9a": rec_a, "9b": rec_b, "9c": rec_c},
            {k.split("_LAUNCHES")[0].lower(): v for k, v in launches.items()},
            errs)


def phase10(rt, dev, launch_log, width=1024, subset=256):
    """The Tracer's remaining engines on the atrium (BASELINE config 3,
    LBVH leaf 16 through build_scene, phase 7's 1024^2 primaries and
    cosine bounce): the grid rounds engine, binned, kz-binned and
    stackless, each against the flat trace, and render_path with the grid
    as bounce_tracer.  Returns its record, the launches of its main-path
    run by counter (zeroed just before it, read just after) and the
    largest |kernel - plain| per kernel over its comparisons."""
    from rtk_tpu_torch.models import path
    from rtk_tpu_torch.ops import packet_trace as pt
    from rtk_tpu_torch.testing import scenes
    from rtk_tpu_torch.testing.binned import subtree_bins
    from rtk_tpu_torch.testing.grid import calibrate_caps, trace_packets_grid

    sync = torch.cuda.synchronize
    counters = ("KERNEL_LAUNCHES", "ROOTS_LAUNCHES", "ANY_LAUNCHES",
                "MASK_LAUNCHES")
    atr = scenes.atrium()
    soup = (atr.reshape(-1, 3), np.arange(atr.shape[0] * 3).reshape(-1, 3))
    odd = np.where(np.arange(atr.shape[0]) % 2 == 1, 1, 2).astype(np.uint32)
    builds = {}
    sync()
    t0 = time.perf_counter()
    scene = rt.build_scene(soup, rt.BuildConfig(leaf_size=16), device=dev)
    flat = rt.Tracer(scene)
    packed = flat.packed
    sync()
    builds["scene_pack_s"] = time.perf_counter() - t0
    eng = {e: rt.Tracer(scene, engine=e)
           for e in ("grid", "binned", "stackless")}
    masked = {e: rt.Tracer(scene, engine=e, tri_mask=odd)
              for e in ("packet", "grid")}
    for name, build in (("grid_s", lambda: eng["grid"].grid),
                        ("masked_grid_s", lambda: masked["grid"].grid),
                        ("stackless_s", lambda: eng["stackless"].stackless)):
        t0 = time.perf_counter()
        build()
        sync()
        builds[name] = time.perf_counter() - t0
    grid = eng["grid"].grid
    cam = scenes.camera_rays(**ATRIUM_CAM, width=width, height=width,
                             order="morton", device=dev)
    n = cam.count
    bounce = cosine_bounce(rt, flat.closest(cam), cam)
    caps = calibrate_caps(grid, bounce)
    mats = path.Materials.make([[0.7, 0.7, 0.7]], device=dev)
    rkw = dict(bounces=4, background=(0.2, 0.3, 0.4))

    def gen():
        return torch.Generator(device=dev).manual_seed(1)

    calls = {
        "grid_bounce": lambda: eng["grid"].closest(bounce),
        "grid_primary": lambda: eng["grid"].closest(cam),
        "grid_any": lambda: eng["grid"].any(bounce),
        "grid_caps": lambda: trace_packets_grid(grid, bounce, caps=caps),
        "grid_mask": lambda: masked["grid"].closest(bounce, filter_mask=1),
        "binned_bounce": lambda: eng["binned"].closest(bounce),
        "binned_any": lambda: eng["binned"].any(bounce),
        "kz_binned": lambda: pt.trace_packets_kz_binned(packed, bounce),
        "render_grid": lambda: path.render_path(
            flat, cam, mats, gen(), bounce_tracer=eng["grid"], **rkw)}
    sync()
    for c in counters:
        setattr(pt, c, 0)
    launch_log.start(10)
    out = {k: f() for k, f in calls.items()}
    sync()
    launch_log.stop()
    launches = {c.split("_LAUNCHES")[0].lower(): getattr(pt, c)
                for c in counters}
    check(all(v > 0 for v in launches.values()),
          f"phase 10 launches {launches}")
    # Each grid call launches its rounds (10) and its residual; the
    # render's four bounce traces are grid calls.
    n_bins = min(8, subtree_bins(packed, 2)[0].shape[0])
    check(launches["roots"] == 10 * 9 + 2 * n_bins,
          f"phase 10: {launches['roots']} roots launches")
    grid_rounds = [{k: r[k] for k in ("rays", "ms", "bound_ms")}
                   for r in launch_log.last[:11]]

    # ---- each engine against the flat trace ----
    ref = {"bounce": flat.closest(bounce), "primary": flat.closest(cam),
           "any": flat.any(bounce),
           "mask": masked["packet"].closest(bounce, filter_mask=1)}
    parity = {}
    for name, want in (("grid_bounce", "bounce"), ("grid_primary",
                                                   "primary"),
                       ("grid_caps", "bounce"), ("grid_mask", "mask"),
                       ("binned_bounce", "bounce")):
        parity[name] = march_parity(out[name], ref[want], f"10 {name}")
    for name in ("grid_any", "binned_any"):
        check(torch.equal(out[name].hit, ref["any"].hit),
              f"10 {name}: any-hit mask")
    gm = out["grid_mask"]
    check(bool((gm.triangle_index[gm.hit] % 2 == 1).all()),
          "10 grid_mask: a triangle the mask rejects")
    same_hits(out["kz_binned"], pt.trace_packets(packed, bounce),
              "10 kz-binned vs trace_packets")
    rad_flat = path.render_path(flat, cam, mats, gen(), **rkw)
    share = float(((out["render_grid"] - rad_flat).abs() <= 1e-4)
                  .all(dim=1).float().mean())
    check(share >= ENGINE_SHARE, f"10 render: grid bounces agree on {share}")
    del out

    # ---- the stackless engine on 256^2 subsets ----
    step = n // subset ** 2
    subs = {"bounce": bounce[::step], "primary": cam[::step]}
    stackless = {}
    for name, sub in subs.items():
        got, ms = timed(lambda: eng["stackless"].closest(sub), warm=False)
        fl = flat.closest(sub)
        stackless[name] = {
            "rays": sub.count, "ms": ms,
            "flat_ms": timed(lambda: flat.closest(sub), reps=3)[1],
            "max_t_err_ties": march_parity(got, fl, f"10 stackless {name}",
                                           "triangle_index")}

    # ---- the kernel against its plain version ----
    errs = {"roots": 0.0, "any": 0.0, "mask": 0.0, "kernel": 0.0}
    vs_plain = {}
    for name, g, sub, kw in (
            ("closest", grid, subs["bounce"], {}),
            ("any", grid, subs["bounce"], {"mode": "any"}),
            ("mask", masked["grid"].grid, subs["bounce"],
             {"filter_mask": 1})):
        (got, (kc, kl)), k_ms = timed(lambda: trace_packets_grid(
            g, sub, debug_counts=True, **kw), warm=False)
        (want, (pc, pl)), p_ms = timed(lambda: trace_packets_grid(
            g, sub, debug_counts=True, plain=True, **kw), warm=False)
        err = compare(got, want, f"10 grid {name} kernel/plain")
        check(err == 0.0 and torch.equal(kc, pc) and int(kl) == int(pl),
              f"10 grid {name}: kernel - plain {err}, or the counts differ")
        same_hits(got, want, f"10 grid {name} kernel/plain")
        # The rounds are roots launches, the residual the mode's variant.
        for k in ("roots", "kernel" if name == "closest" else name):
            errs[k] = max(errs[k], err)
        vs_plain[f"grid_{name}"] = {"rays": sub.count, "ms": k_ms,
                                    "plain_ms": p_ms, "max_abs_err": err}
    # One launch whose roots include leaf entries (-2 - leaf: a third of
    # the rays that hit, at the leaf of their flat hit) beside the depth-2
    # bins' node rows, kernel against plain, bit for bit.
    sub = subs["bounce"]
    fl = flat.closest(sub)
    bins = torch.as_tensor(subtree_bins(packed, 2)[0], device=dev)
    i = torch.arange(sub.count, device=dev)
    roots = torch.where((i % 3 == 0) & fl.hit,
                        -2 - fl.slot // packed.leaf_size,
                        bins[i % bins.shape[0]]).to(torch.int32)
    got = pt.trace_packets(packed, sub, ray_roots=roots, sort_rays=False)
    want = pt.trace_packets_reference(packed, sub, ray_roots=roots,
                                      sort_rays=False)
    err = compare(got, want, "10 leaf roots kernel/plain")
    same_hits(got, want, "10 leaf roots kernel/plain")
    leafy = roots <= -2
    check(bool(got.hit[leafy].any()), "10 leaf roots: no leaf-rooted hit")
    errs["roots"] = max(errs["roots"], err)
    vs_plain["leaf_roots"] = {"rays": sub.count, "leaf_rooted": int(
        leafy.sum()), "leaf_rooted_hits": int(got.hit[leafy].sum()),
        "max_abs_err": err}

    # ---- steady ms, the grid's counts and its host syncs ----
    ms = {k: timed(f, reps=3)[1] for k, f in calls.items()}
    ms.update(flat_bounce=timed(lambda: flat.closest(bounce), reps=3)[1],
              flat_primary=timed(lambda: flat.closest(cam), reps=3)[1],
              flat_any=timed(lambda: flat.any(bounce), reps=3)[1],
              flat_mask=timed(lambda: masked["packet"].closest(
                  bounce, filter_mask=1), reps=3)[1],
              render_flat=timed(lambda: path.render_path(
                  flat, cam, mats, gen(), **rkw), reps=3)[1])
    # Where a grid call's time goes: the card's busy share over one call
    # (device events a launch of its ten rounds and residual) and the
    # device kernels that take the most of it.
    profile = {name: profile_clip(calls[name], k, pt)
               for name, k in (("grid_bounce", 11),
                               ("binned_bounce", n_bins + 1))}
    prof, _ = kept_profile(calls["grid_bounce"])
    kernels = sorted(
        ((e.key, getattr(e, "device_time_total", 0.0) / 1e3, e.count)
         for e in prof.key_averages()
         if e.device_type == torch.autograd.DeviceType.CUDA
         and SPIN_KERNEL not in e.key),
        key=lambda r: -r[1])
    profile["grid_bounce"]["top_device_kernels_ms"] = [
        [name[:60], ms, count] for name, ms, count in kernels[:8]]
    _, (cnts, live) = trace_packets_grid(grid, bounce, debug_counts=True)
    _, (ccnts, clive) = trace_packets_grid(grid, bounce, caps=caps,
                                           debug_counts=True)
    rec = {"tris": scene.num_tris, "rays": n, **builds,
           "dims": grid.dims, "occupied_cells": grid.n_occ,
           "cells_rows": grid.cells.num_nodes, "bins": n_bins,
           "live_bounce_rays": int((bounce.max_t > bounce.min_t).sum()),
           "launches": launches, "ms": ms,
           "grid_rounds": {"counts": cnts.tolist(), "residual_live":
                           int(live), "caps": caps, "caps_counts":
                           ccnts.tolist(), "caps_residual_live": int(clive),
                           "replayed_launches": grid_rounds},
           "profile": profile,
           "grid_host_syncs": host_syncs(calls["grid_bounce"]),
           "binned_host_syncs": host_syncs(calls["binned_bounce"]),
           "parity_max_t_err_ties": parity, "render_agree_share": share,
           "stackless": stackless, "kernel_vs_plain": vs_plain}
    return rec, launches, errs


def bits_same(a, b, what, fields=("hit", "slot", "t", "u", "v")):
    """The fields of two hit records equal bit for bit."""
    for f in fields:
        check(bits_equal(getattr(a, f), getattr(b, f)),
              f"{what}: {f} differs")


def scene_parity(got, want, what):
    """A scene-sharded closest trace against one scene's: equal hit masks,
    t within 1e-6*(1+|t|), another triangle only at an exact-t tie (the
    parts' trees meet the tie in another order) -> (max |t err|, ties)."""
    return march_parity(got, want, what, "triangle_index")


def any_records(sscene, rays, got, whole_any, what):
    """Scene-sharded any-hit: the hit mask of one scene's any-hit trace,
    and every record the whole record of the part that produced it (the
    lowest part that hits), bit for bit; a miss keeps max_t and slot -1.
    The parts' own traces are comparisons, outside the main path."""
    from rtk_tpu_torch.ops.packet_trace import trace_packets

    check(torch.equal(got.hit, whole_any.hit), f"{what}: hit mask")
    rank = torch.where(got.hit, got.slot // sscene.part_tris,
                       sscene.num_parts)
    for r, part in enumerate(sscene.parts):
        want = trace_packets(part, rays, mode="any")
        check(not bool((want.hit & (rank > r)).any()),
              f"{what}: a lower part hits")
        mine = rank == r
        local = got.slot - r * sscene.part_tris
        for f, a in (("t", got.t), ("u", got.u), ("v", got.v),
                     ("slot", local)):
            check(bits_equal(a[mine], getattr(want, f)[mine]),
                  f"{what}: part {r}'s {f}")
    miss = ~got.hit
    check(bool((got.slot[miss] == -1).all())
          and torch.equal(got.t[miss], rays.max_t[miss]),
          f"{what}: a miss's record")
    return int(got.hit.sum())


def phase11(rt, dev, launch_log, inst, width=8192, subset=256,
            atrium_width=1024):
    """Sharding (parallel/shard.py) at full width on meshes whose entries
    name the one card: (a) ray sharding of the headline (blob(6), LBVH
    leaf 4, 8192^2 Morton rays) on default_mesh() and on 4 entries, the
    stack engine and a ray_index filter on a 256^2 subset; (b) the atrium
    (BASELINE config 3) in 4 parts and on the hybrid 2 x 2 mesh, 1024^2
    primaries and phase 7's cosine bounce, against one scene of the same
    config; (c) config 5's instanced trace (phase 5's LBVH forest and
    rays) and the atrium bounce through the grid rounds engine, each on 2
    entries.  Returns its record, the launches of its run by counter
    (zeroed just before, read just after) and the headline's tables."""
    from rtk_tpu_torch import instancing
    from rtk_tpu_torch.ops import packet_trace as pt
    from rtk_tpu_torch.parallel import shard
    from rtk_tpu_torch.testing import scenes
    from rtk_tpu_torch.testing.grid import trace_packets_grid
    from rtk_tpu_torch.trace.packed import pack_scene

    sync = torch.cuda.synchronize
    counters = ("KERNEL_LAUNCHES", "ROOTS_LAUNCHES", "ANY_LAUNCHES")
    mesh1, mesh2, mesh4 = (shard.default_mesh(), shard.Mesh([dev] * 2),
                           shard.Mesh([dev] * 4))
    hybrid = shard.hybrid_mesh(2, [dev] * 4)
    builds = {}

    def build(name, fn):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        builds[name] = (time.perf_counter() - t0) * 1e3
        return out

    # (a) the headline's tables and rays, and a strided subset.
    v6, f6 = scenes.blob(6)[1:]
    scene6 = build("blob6_ms", lambda: rt.build_scene((v6, f6), device=dev))
    packed6 = build("blob6_pack_ms", lambda: rt.Tracer(scene6).packed)
    rays = scenes.camera_rays(**CAM, width=width, height=width,
                              order="morton", device=dev, on_device=True)
    sub = rays[::rays.count // subset ** 2]
    half = sub.count // 2

    def first_half(c):
        return c.ray_index < half

    # (b) the atrium whole (one scene), in 4 parts and in 2 x 2.
    atr = scenes.atrium()
    soup = (atr.reshape(-1, 3), np.arange(atr.shape[0] * 3).reshape(-1, 3))
    cfg = rt.BuildConfig(branching=8, leaf_size=8)
    whole = build("atrium_whole_ms", lambda: pack_scene(
        rt.build_from_soup(atr, config=cfg, device=dev)))
    ss4 = build("atrium_4_parts_ms",
                lambda: shard.build_scene_sharded(soup, mesh4, cfg))
    ss2 = build("atrium_2x2_ms",
                lambda: shard.build_scene_sharded(soup, hybrid, cfg))
    cam = scenes.camera_rays(**ATRIUM_CAM, width=atrium_width,
                             height=atrium_width, order="morton", device=dev)
    bounce = cosine_bounce(rt, pt.trace_packets(whole, cam), cam)
    # (c) phase 5's forest and rays; the atrium's grid (phase 10's).
    scene16 = build("atrium_leaf16_ms", lambda: rt.build_scene(
        soup, rt.BuildConfig(leaf_size=16), device=dev))
    grid = build("atrium_grid_ms",
                 lambda: rt.Tracer(scene16, engine="grid").grid)
    ikw = dict(max_candidates=INST_CANDIDATES)
    calls = {
        "ray_default": lambda: shard.trace_packets_sharded(packed6, rays,
                                                           mesh1),
        "ray_4": lambda: shard.trace_packets_sharded(packed6, rays, mesh4),
        "ray_direct": lambda: pt.trace_packets(packed6, rays),
        "stack_4": lambda: shard.trace_closest_sharded(scene6, sub, mesh4),
        "stack_direct": lambda: rt.trace_closest(scene6, sub),
        "filter_4": lambda: shard.trace_closest_sharded(
            scene6, sub, mesh4, filter_fn=first_half),
        "filter_direct": lambda: rt.trace_closest(scene6, sub,
                                                  filter_fn=first_half),
        "scene_primary": lambda: shard.trace_closest_scene_sharded(
            ss4, cam, mesh4),
        "scene_bounce": lambda: shard.trace_closest_scene_sharded(
            ss4, bounce, mesh4),
        "scene_any": lambda: shard.trace_any_scene_sharded(ss4, bounce,
                                                           mesh4),
        "hybrid_bounce": lambda: shard.trace_closest_scene_sharded(
            ss2, bounce, hybrid),
        "hybrid_any": lambda: shard.trace_any_scene_sharded(ss2, bounce,
                                                            hybrid),
        "whole_primary": lambda: pt.trace_packets(whole, cam),
        "whole_bounce": lambda: pt.trace_packets(whole, bounce),
        "whole_any": lambda: pt.trace_packets(whole, bounce, mode="any"),
        "instanced_2": lambda: shard.trace_instanced_sharded(
            inst.ps, inst.rays, mesh2, **ikw),
        "instanced_direct": lambda: rt.trace_closest_instanced_packets(
            inst.ps, inst.rays, **ikw),
        "grid_2": lambda: shard.trace_grid_sharded(grid, bounce, mesh2),
        "grid_direct": lambda: trace_packets_grid(grid, bounce)}

    # The exactness residual's size, sharded (once over every shard's
    # unproven rays) and unsharded.
    residual, res = [], instancing._residual
    sync()
    for c in counters:
        setattr(pt, c, 0)
    launch_log.start(11)
    instancing._residual = lambda *a: residual.append(res(*a)) or residual[-1]
    try:
        out = {k: f() for k, f in calls.items()}
    finally:
        instancing._residual = res
    sync()
    launch_log.stop()
    launches = {c.split("_LAUNCHES")[0].lower(): getattr(pt, c)
                for c in counters}
    check(all(v > 0 for v in launches.values()),
          f"phase 11 launches {launches}")

    # (a) each ray's trace is independent of its batch: bit for bit.
    for name in ("ray_default", "ray_4"):
        bits_same(out[name], out["ray_direct"], f"11 {name}")
    n_hit = int(out["ray_direct"].hit.sum())
    check(abs(n_hit - HEADLINE_EXPECT_HITS) <= HEADLINE_HIT_TOL,
          f"11 headline hit count {n_hit}")
    hfields = [f.name for f in dataclasses.fields(rt.Hits)]
    for name in ("stack", "filter"):
        bits_same(out[f"{name}_4"], out[f"{name}_direct"], f"11 {name}",
                  hfields)
    fh = out["filter_4"].hit
    check(bool(fh[:half].any()) and not bool(fh[half:].any()),
          "11 filter: a hit past the caller's first half")
    # (b) against one scene; any-hit records against their parts.
    parity = {
        "scene_primary": scene_parity(out["scene_primary"],
                                      out["whole_primary"], "11 primary"),
        "scene_bounce": scene_parity(out["scene_bounce"],
                                     out["whole_bounce"], "11 bounce"),
        "hybrid_bounce": scene_parity(out["hybrid_bounce"],
                                      out["whole_bounce"], "11 hybrid")}
    any_hits = {
        "scene_any": any_records(ss4, bounce, out["scene_any"],
                                 out["whole_any"], "11 any"),
        "hybrid_any": any_records(ss2, bounce, out["hybrid_any"],
                                  out["whole_any"], "11 hybrid any")}
    # (c) phase 5's bars, and the grid at tests/test_grid.py's.
    parity["instanced"] = compare_instanced(
        out["instanced_2"], out["instanced_direct"], "11 instanced",
        FOREST_T_TOL)
    parity["grid"] = march_parity(out["grid_2"], out["grid_direct"],
                                  "11 grid")
    bit_equal = {}
    for name, a, b in (("instanced", out["instanced_2"][0],
                        out["instanced_direct"][0]),
                       ("grid", out["grid_2"], out["grid_direct"])):
        bit_equal[name] = all(bits_equal(getattr(a, f), getattr(b, f))
                              for f in ("hit", "slot", "t", "u", "v"))
    del out

    # ms per call (CUDA events, after a warm call) and the device events
    # of one more call.
    slow = ("stack_4", "stack_direct", "filter_4", "filter_direct")
    ms = {k: timed(f, reps=1 if k in slow else 3, warm=k not in slow)[1]
          for k, f in calls.items()}
    events = {k: kept_profile(calls[k])[1] for k in (
        "ray_4", "ray_direct", "scene_bounce", "hybrid_bounce",
        "whole_bounce", "instanced_2", "instanced_direct", "grid_2",
        "grid_direct")}
    return {"rays": rays.count, "subset": sub.count, "headline_hits": n_hit,
            "atrium_tris": int(atr.shape[0]), "atrium_rays": cam.count,
            "parts": ss4.num_parts, "part_tris": ss4.part_tris,
            "hybrid": hybrid.shape, "builds_ms": builds,
            "launches": launches, "residual_sharded_direct": residual,
            "max_t_err_ties": parity, "any_hits": any_hits,
            "bit_equal": bit_equal, "ms": ms,
            "device_events": events}, launches, packed6


# The serving process of phase 12: a fresh interpreter with no nvcc on its
# PATH and CUDA_HOME an empty directory.  It loads the scene blobs and the
# artifacts, traces, and writes its outputs for the parent to compare.
AOT_SERVER = r"""
import json, os, shutil, sys, time
t_start = time.time()
import torch
from rtk_tpu_torch.ops import library, packet_trace
from rtk_tpu_torch.testing import scenes
from rtk_tpu_torch.utils.aot import load_packet_trace, load_refit_trace
from rtk_tpu_torch.utils.serialize import load_packed_scene
d, args = sys.argv[1], json.loads(sys.argv[2])
assert shutil.which("nvcc") is None, "nvcc on the server's PATH"
assert not os.path.exists(os.path.join(os.environ["CUDA_HOME"], "bin"))
dev = torch.device(args["device"])
t_import = time.time()
packed = load_packed_scene(os.path.join(d, "scene.rtk"), device=dev)
with open(os.path.join(d, "trace.aot"), "rb") as f:
    trace = load_packet_trace(f.read())
t_load = time.time()
rays = scenes.camera_rays(**args["cam"], width=args["width"],
                          height=args["width"], order="morton", device=dev,
                          on_device=True)
hits = trace(packed, rays)
if dev.type == "cuda":
    torch.cuda.synchronize()
t_first = time.time()
fields = ("hit", "slot", "t", "u", "v")
torch.save({f: getattr(hits, f).cpu() for f in fields},
           os.path.join(d, "headline.pt"))
del hits, rays
grid = load_packed_scene(os.path.join(d, "grid.rtk"), device=dev)
with open(os.path.join(d, "refit.aot"), "rb") as f:
    refit = load_refit_trace(f.read())
cam = scenes.camera_rays(**args["grid_cam"], width=args["grid_width"],
                         height=args["grid_width"], order="morton",
                         device=dev)
frames = []
for i in range(1, args["frames"] + 1):
    h = refit(grid, torch.as_tensor(
        scenes.deforming_grid(0.05 * i, n=args["grid_n"]), device=dev), cam)
    frames.append({f: getattr(h, f).cpu() for f in fields + ("tri_v",)})
torch.save(frames, os.path.join(d, "frames.pt"))
print(json.dumps({"t_start": t_start, "import_s": t_import - t_start,
                  "load_s": t_load - t_import,
                  "first_trace_s": t_first - t_load, "t_first": t_first,
                  "builds": sorted(map(str, packet_trace.BUILD_SECONDS)),
                  "libs": sorted(map(str, library._libs)),
                  "launches": packet_trace.KERNEL_LAUNCHES,
                  "key_launches": packet_trace.KEY_LAUNCHES,
                  "unsort_launches": packet_trace.UNSORT_LAUNCHES}))
"""


def phase12(rt, dev, launch_log, packed6, width=8192, grid_n=96,
            grid_width=256, frames=8):
    """AOT serving (utils/aot.py): export the headline's program (phase
    11's blob(6) tables, LBVH leaf 4, 8192^2, closest) and config 4's refit program (8a's
    deforming grid, LBVH leaf 8 without wide nodes, 256^2, 8 frames of
    its clip); run a fresh server process without nvcc that loads them,
    traces and writes its outputs, which must equal the direct calls of
    this process bit for bit, with no kernel build in the server.  Its
    launches are not in this process's counts.  Returns its record and
    the launches of the direct calls by counter."""
    from rtk_tpu_torch.ops import packet_trace as pt
    from rtk_tpu_torch.testing import scenes
    from rtk_tpu_torch.trace.packed import pack_scene
    from rtk_tpu_torch.utils import aot
    from rtk_tpu_torch.utils.serialize import save_packed_scene

    sync = torch.cuda.synchronize
    rays = scenes.camera_rays(**CAM, width=width, height=width,
                              order="morton", device=dev, on_device=True)
    g0 = scenes.deforming_grid(0.0, n=grid_n)
    gscene = rt.build_from_soup(g0, config=rt.BuildConfig(
        branching=8, leaf_size=8, wide_nodes=False), device=dev)
    gpacked = pack_scene(gscene)
    cam = scenes.camera_rays(**GRID_CAM, width=grid_width, height=grid_width,
                             order="morton", device=dev)
    clip = [torch.as_tensor(scenes.deforming_grid(0.05 * i, n=grid_n),
                            device=dev) for i in range(1, frames + 1)]
    rec = {"rays": rays.count, "grid_tris": gscene.num_tris,
           "grid_rays": cam.count, "frames": frames}
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        blob = aot.export_packet_trace(packed6, rays.count)
        rec["export_ms"] = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        rblob = aot.export_refit_trace(gpacked, gscene, cam.count)
        rec["refit_export_ms"] = (time.perf_counter() - t0) * 1e3
        rec.update(artifact_bytes=len(blob), refit_artifact_bytes=len(rblob))
        for name, data in (("trace.aot", blob), ("refit.aot", rblob)):
            with open(os.path.join(d, name), "wb") as f:
                f.write(data)
        save_packed_scene(packed6, os.path.join(d, "scene.rtk"))
        save_packed_scene(gpacked, os.path.join(d, "grid.rtk"))

        # The direct calls (the main path that the server replaces).
        sync()
        pt.KERNEL_LAUNCHES = 0
        launch_log.start(12)
        want = pt.trace_packets(packed6, rays)
        want_frames = [pt.trace_packets_refit(gpacked, gscene, c, cam)[0]
                       for c in clip]
        sync()
        launch_log.stop()
        launches = {"kernel": pt.KERNEL_LAUNCHES}

        # The server: no nvcc anywhere it looks.
        cuda_home = os.path.join(d, "no_cuda")
        os.mkdir(cuda_home)
        path = os.pathsep.join(
            p for p in os.environ.get("PATH", "").split(os.pathsep)
            if not os.path.isfile(os.path.join(p, "nvcc")))
        args = {"cam": CAM, "width": width, "grid_cam": GRID_CAM,
                "grid_width": grid_width, "grid_n": grid_n, "frames": frames,
                "device": str(dev)}
        repo = os.path.dirname(os.path.abspath(__file__))
        t_spawn = time.time()
        proc = subprocess.run(
            [sys.executable, "-c", AOT_SERVER, d, json.dumps(args)],
            cwd=repo, capture_output=True, text=True, timeout=300,
            env={**os.environ, "PATH": path, "CUDA_HOME": cuda_home,
                 "PYTHONPATH": repo})
        check(proc.returncode == 0,
              f"12 server failed:\n{proc.stdout}{proc.stderr[-4000:]}")
        srv = json.loads(proc.stdout.strip().splitlines()[-1])
        check(not srv["builds"] and not srv["libs"],
              f"12 server built or loaded a kernel itself: {srv}")
        # Both artifacts' batches are sorted: the server's key and unsort
        # ran from the embedded library.
        check(srv["key_launches"] > 0 and srv["unsort_launches"] > 0,
              f"12 server sorted no batch through its library: {srv}")
        got = torch.load(os.path.join(d, "headline.pt"))
        for f, a in got.items():
            check(bits_equal(a.to(dev), getattr(want, f)),
                  f"12 server headline: {f} differs")
        got = torch.load(os.path.join(d, "frames.pt"))
        for i, (g, w) in enumerate(zip(got, want_frames, strict=True)):
            for f, a in g.items():
                check(bits_equal(a.to(dev), getattr(w, f)),
                      f"12 server frame {i}: {f} differs")
    rec.update(server={
        "spawn_to_first_result_s": srv["t_first"] - t_spawn,
        "interpreter_start_s": srv["t_start"] - t_spawn,
        **{k: srv[k] for k in ("import_s", "load_s", "first_trace_s",
                               "launches", "key_launches",
                               "unsort_launches", "builds")}},
        headline_hits=int(want.hit.sum()))

    # Steady state in this process: the loaded artifacts beside the
    # direct calls (CUDA events, after a warm call).
    lt, lr = aot.load_packet_trace(blob), aot.load_refit_trace(rblob)
    bits_same(lt(packed6, rays), want, "12 LoadedTrace")
    rec["ms"] = {
        "loaded_trace": timed(lambda: lt(packed6, rays), reps=3)[1],
        "trace_packets": timed(lambda: pt.trace_packets(packed6, rays),
                               reps=3)[1],
        "loaded_refit_frame": timed(lambda: lr(gpacked, clip[0], cam),
                                    reps=3)[1],
        "trace_packets_refit_frame": timed(lambda: pt.trace_packets_refit(
            gpacked, gscene, clip[0], cam), reps=3)[1]}
    return rec, launches


def load_tool(name):
    """tools/{name}.py of this checkout, imported (the folder appended to
    sys.path, where the tools find each other)."""
    tools = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools")
    if tools not in sys.path:
        sys.path.append(tools)
    return importlib.import_module(name)


def phase13(rt, dev, launch_log, v6, f6, sides=COST_SIDES):
    """The cost model (utils/costmodel.py) against a cut sweep of the main
    path: build_scene(blob(6)) -> Tracer.closest on Morton primaries at
    each side^2.  The main path is one closest call and one stats trace
    (unsorted rays: the counts steps_per_block reads) per size; then
    tools/torch_costmodel_fit.py's measure() times each size outside it.
    Checks: dispatch_bound is True at the smallest size and False at the
    largest, and agrees there with what was measured (the card's busy ms
    of the call against this run's fixed cost of a call, the intercept of
    the walls at 1024^2 and 4096^2, as the fit reads DISPATCH_MS; the
    wall less the card's busy ms at SORT_RAYS_MIN rays is printed beside
    it); StepModel().trace_ms from the measured
    steps_per_block is within COST_TOL of the measured wall at
    COST_CHECK_SIDES; auto_pkt is a multiple of 128; the smallest size's
    records and steps_per_block equal the plain version's.  Returns its
    record, the launches by counter and the closest records' max
    |kernel - plain| at the smallest size."""
    from rtk_tpu_torch.ops import packet_trace as pt
    from rtk_tpu_torch.testing import scenes
    from rtk_tpu_torch.utils import costmodel as cm
    from rtk_tpu_torch.utils.stats import steps_per_block

    tool = load_tool("torch_costmodel_fit")

    tracer = rt.Tracer(rt.build_scene((v6, f6), device=dev))
    rays = {s: scenes.camera_rays(**CAM, width=s, height=s, order="morton",
                                  device=dev, on_device=True) for s in sides}
    torch.cuda.synchronize()
    pt.KERNEL_LAUNCHES = pt.STATS_LAUNCHES = pt.KEY_LAUNCHES = 0
    pt.UNSORT_LAUNCHES = 0
    launch_log.start(13)
    hits, spb = {}, {}
    for s, r in rays.items():
        hits[s] = tracer.closest(r)
        spb[s] = steps_per_block(pt.trace_packets(
            tracer.packed, r, sort_rays=False, stats=True)[1][0])
    torch.cuda.synchronize()
    launch_log.stop()
    launches = {"kernel": pt.KERNEL_LAUNCHES, "stats": pt.STATS_LAUNCHES,
                "key": pt.KEY_LAUNCHES, "unsort": pt.UNSORT_LAUNCHES}
    for s, h in hits.items():
        check(int(h.hit.sum()) > 0 and bool(torch.isfinite(h.t[h.hit]).all()),
              f"13 {s}^2: no hit or a non-finite hit t")
    small, big = min(sides), max(sides)
    err = compare(hits[small], pt.trace_packets_reference(
        tracer.packed, rays[small]), f"13 {small}^2 kernel/plain")
    _, counts = pt.trace_packets_reference(tracer.packed, rays[small],
                                           sort_rays=False, stats=True)
    check(steps_per_block(counts[0]) == spb[small],
          f"13 {small}^2: steps_per_block differs from the plain version's")

    meas = {s: tool.measure(tracer, r) for s, r in rays.items()}
    fixed_ms = tool.fixed_ms(meas)
    model = cm.StepModel()
    rec = {"fixed_ms": fixed_ms,
           "host_share_128_ms": tool.host_share_ms(meas, pt.SORT_RAYS_MIN),
           "sizes": {}}
    for s, m in meas.items():
        n = s * s
        pkt = cm.auto_pkt(n)
        check(pkt % 128 == 0, f"13 auto_pkt({n}) = {pkt}")
        pred = model.trace_ms(n, pkt, spb[s])
        rec["sizes"][s] = {
            **m, "steps_per_block": spb[s], "auto_pkt": pkt,
            "predicted_ms": pred,
            "rel_err": (pred - m["wall_ms"]) / m["wall_ms"],
            "dispatch_bound": cm.dispatch_bound(n),
            "measured_bound": m["device_ms"] < fixed_ms}
    got = rec["sizes"]
    check(got[small]["dispatch_bound"] and not got[big]["dispatch_bound"],
          f"13 dispatch_bound: {small}^2 {got[small]['dispatch_bound']}, "
          f"{big}^2 {got[big]['dispatch_bound']}")
    for s in (small, big):
        check(got[s]["dispatch_bound"] == got[s]["measured_bound"],
              f"13 {s}^2: dispatch_bound {got[s]['dispatch_bound']}, device "
              f"{got[s]['device_ms']:.4f} ms against a fixed cost of "
              f"{fixed_ms:.4f} ms")
    for s in COST_CHECK_SIDES:
        check(abs(got[s]["rel_err"]) <= COST_TOL,
              f"13 {s}^2: predicted {got[s]['predicted_ms']:.4f} ms, measured "
              f"{got[s]['wall_ms']:.4f} ({got[s]['rel_err']:+.3f})")
    rec["model"] = {"A_US": cm.A_US, "B_US": cm.B_US, "C_US": cm.C_US,
                    "DISPATCH_MS": cm.DISPATCH_MS, "tol": COST_TOL}
    return rec, launches, err


def card_us(fn, reps=CARD_REPS):
    """The card's us a call of fn at its own pace: `reps` back-to-back
    calls queued behind a spin on the card (torch.cuda._sleep), CUDA
    events around them, so the host's issue time is hidden.  Fails if the
    host took longer to issue them than the spin lasted."""
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
    spin_ms = e0.elapsed_time(e1)
    check(issue_ms < spin_ms, f"card_us: the host took {issue_ms:.3f} ms to "
          f"issue {reps} calls, the spin lasted {spin_ms:.3f}")
    return e1.elapsed_time(e2) / reps * 1e3


def padded_profile(run, frames=1):
    """torch.profiler over one call of run() in a window that opens and
    closes with PAD_SPINS short spins on the card (torch.cuda._sleep),
    finished before run() starts and started after it ends: every
    profiler window of the smoke.  Late in a long process, and more after
    it has started another that uses the card, the profiler loses the
    first device records of a window, up to all of a short call's, and
    once it kept a window's leading spins and none of the call's records;
    the spins take such losses (on the H100, 0-13 leading spins in most
    windows, once 252, and more than 32 in three windows in a row right
    after phase 12's server).  -> (profile,
    device_share's record over `frames` frames with spins_lost and
    tail_spins_lost, the spins the profiler lost before and after run()'s
    records; a window with no record of run() counts all spins lost)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(PAD_SPINS):
            torch.cuda._sleep(100)
        torch.cuda.synchronize()
        run()
        torch.cuda.synchronize()
        for _ in range(PAD_SPINS):
            torch.cuda._sleep(100)
        torch.cuda.synchronize()
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    spins = [e.time_range.start for e in dev if SPIN_KERNEL in e.name]
    calls = [e.time_range for e in dev if SPIN_KERNEL not in e.name]
    lead = tail = 0
    if calls:
        first = min(r.start for r in calls)
        last = max(r.end for r in calls)
        lead = sum(t < first for t in spins)
        tail = sum(t >= last for t in spins)
    return prof, {**device_share(prof, frames),
                  "spins_lost": PAD_SPINS - lead,
                  "tail_spins_lost": PAD_SPINS - tail}


def clean_window(rec):
    """A padded_profile window whose losses stayed in its spins: one spin
    recorded before run()'s records and one after them."""
    return rec["spins_lost"] < PAD_SPINS and rec["tail_spins_lost"] < PAD_SPINS


def kept_profile(run, frames=1):
    """padded_profile, tried up to PROFILE_WINDOWS times until the window
    is clean (clean_window, padded_windows' rule), so that no window whose
    loss may have reached run()'s records is kept; fails if no try was
    -> padded_profile's (profile, record)."""
    for _ in range(PROFILE_WINDOWS):
        prof, rec = padded_profile(run, frames)
        if clean_window(rec):
            return prof, rec
    raise RuntimeError(f"the profiler's losses reached the call in each of "
                       f"{PROFILE_WINDOWS} windows")


def padded_windows(run):
    """The clean records (clean_window) of PROFILE_WINDOWS padded_profile
    windows of one call each, and of up to PROFILE_WINDOWS more while none
    is clean; fails if none is."""
    recs = []
    for i in range(2 * PROFILE_WINDOWS):
        if i >= PROFILE_WINDOWS and recs:
            break
        rec = padded_profile(run)[1]
        if clean_window(rec):
            recs.append(rec)
    check(recs, f"the profiler's losses reached the call in each of "
          f"{2 * PROFILE_WINDOWS} windows")
    return recs


def sync_wall_ms(run):
    """The host's ms of one call of run() and a synchronize (latency, not
    the issue rate): the median of WALL_CALLS, outside the profiler."""
    walls = []
    for _ in range(WALL_CALLS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(walls))


def host_split(run, floors_us):
    """One call of run() split between the card and the host: wall_ms
    (sync_wall_ms), the card's busy ms, device events and idle share of
    one call (padded_windows: of its clean windows the one with the most
    events; its spins_lost and tail_spins_lost), wall_less_busy_ms, and
    the device events times each per-launch floor of floors_us ({name:
    us}, phase 14a) as events_x_{name}_ms.  Calls run() 1 + WALL_CALLS +
    PROFILE_WINDOWS times (up to PROFILE_WINDOWS more when no window is
    clean)."""
    run()
    wall = sync_wall_ms(run)
    ev = max(padded_windows(run), key=lambda r: r["device_events"])
    check(ev["device_events"] > 0, "host_split: no device event recorded")
    return {"wall_ms": wall, "busy_ms": ev["busy_ms"],
            "device_events": ev["device_events"],
            "idle_share": ev["idle_share"], "spins_lost": ev["spins_lost"],
            "tail_spins_lost": ev["tail_spins_lost"],
            "wall_less_busy_ms": wall - ev["busy_ms"],
            **{f"events_x_{k}_ms": ev["device_events"] * us / 1e3
               for k, us in floors_us.items()}}


def phase14(rt, dev, ptrace, prefit, v6, f6):
    """The profiling entry points (tools/torch_profile_trace.py, phase 1's
    build of its probe, and tools/torch_profile_refit.py).
    14a: the probe on PROBE_SEED's special values, bit-equal to its plain
    version on the card, PROBE_LAUNCHES equal to the calls made; per
    launch, for the probe and for one eager x + 1.0: the host's us (the
    tool's timeit, the pipelined issue rate: the floor), the card's us
    (card_us) and one synchronised call's us (sync_wall_ms: latency).
    14b: torch_profile_trace.py's stages (b) to (d) at 1024^2 (stage (a) is
    14a), sorted and unsorted records equal, the raw kernel's equal to the
    unsorted trace's; then Tracer.closest on blob(6) (phase 13's setup) at
    FIXED_SIDES and at KEY_EVENTS_SIDE (sorted), and that call's coherence
    key alone.  14c: torch_profile_refit.py's stages on config 4, the
    fused frame's records and tables equal to the stages' one after
    another.  Every stage of 14b and 14c: the tool's timeit ms and
    host_split with 14a's two floors.  Returns (14a, 14b, 14c), the
    probe's launches and its kernels-line row."""
    from rtk_tpu_torch.ops.morton import ray_coherence_key
    from rtk_tpu_torch.testing import scenes

    # 14a: the probe, counted from here.
    x = torch.as_tensor(ptrace.probe_input(PROBE_SEED), device=dev)
    ptrace.PROBE_LAUNCHES = 0
    out = ptrace.dispatch_probe(x)
    want = ptrace.dispatch_probe_reference(x)
    torch.cuda.synchronize()
    check(bits_equal(out, want), "14a: the probe differs from x + 1.0")
    fns = {"probe": lambda: ptrace.dispatch_probe(x),
           "eager": lambda: ptrace.dispatch_probe_reference(x)}
    floors = {k: ptrace.timeit(f, FLOOR_ITERS, FLOOR_BATCHES) * 1e6
              for k, f in fns.items()}
    cards = {k: card_us(f) for k, f in fns.items()}
    syncs = {k: sync_wall_ms(f) * 1e3 for k, f in fns.items()}
    calls = (1 + (1 + FLOOR_ITERS * FLOOR_BATCHES) + (1 + CARD_REPS)
             + WALL_CALLS)
    launches = ptrace.PROBE_LAUNCHES
    check(launches == calls, f"14a: PROBE_LAUNCHES {launches}, {calls} calls")
    nbytes = 2 * x.numel() * 4
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = x.numel() / PEAK_F32_INSTR * 1e3
    rec_a = {"build_s": ptrace.BUILD_SECONDS, "shape": list(x.shape),
             "bits_equal": True, "launches": launches, "calls": calls,
             "host_floor_us": floors, "card_us": cards,
             "sync_call_us": syncs, "bound_us": max(t_bytes, t_ops) * 1e3,
             "regimes": "host_floor_us: back-to-back calls, the host's "
                        "issue rate; card_us: back-to-back on the card "
                        "behind a spin; sync_call_us: one call and a "
                        "synchronize"}
    row = {"name": "dispatch_probe", "route": "cuda",
           "source": "rtk_tpu_torch/csrc/dispatch_probe.cu",
           "replaces": "tools/profile_trace.py:60", "launches": launches,
           "max_abs_err": 0.0, "ms": cards["probe"] / 1e3,
           "plain_ms": cards["eager"] / 1e3,
           "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "library_ms": cards["eager"] / 1e3,
           "shape": "(8, 128) f32 of 14a's seeded special values; ms: "
                    "back-to-back launches on the card (CUDA events, "
                    "queued behind a spin); plain_ms and library_ms are "
                    "the same call, one eager x + 1.0, which is both the "
                    "plain version and the PyTorch call"}

    # 14b: the trace path's stages.
    packed = ptrace.build_packed(dev)
    rays = ptrace.camera(dev)
    stages = ptrace.trace_stages(packed, rays)
    raw, unsorted, srt = (stages[k]() for k in (
        "raw_kernel", "trace_unsorted", "trace_sorted"))
    check(int(unsorted.hit.sum()) > 0, "14b: no hit")
    bits_same(srt, unsorted, "14b sorted/unsorted")
    hit = raw[3] >= 0
    bits_same(SimpleNamespace(hit=hit, slot=raw[3], t=raw[0],
                              u=torch.where(hit, raw[1], 0.0),
                              v=torch.where(hit, raw[2], 0.0)),
              unsorted, "14b raw kernel/unsorted trace")
    rec_b = {"rays": rays.count, "hits": int(unsorted.hit.sum()),
             "stage_a": "14a", "stages": {}}
    for name, fn in stages.items():
        ms = ptrace.timeit(fn) * 1e3
        rec_b["stages"][name] = {"ms": ms,
                                 "mrays_s": rays.count / ms / 1e3,
                                 **host_split(fn, floors)}
    tracer = rt.Tracer(rt.build_scene((v6, f6), device=dev))
    for s in (*FIXED_SIDES, KEY_EVENTS_SIDE):
        r = scenes.camera_rays(**CAM, width=s, height=s, order="morton",
                               device=dev, on_device=True)
        rec_b["stages"][f"closest_{s}"] = host_split(
            lambda: tracer.closest(r), floors)
    # The sorted call's coherence key alone (its device events: the
    # memset and three launches of csrc/coherence_key.cu).
    rec_b["stages"][f"key_{KEY_EVENTS_SIDE}"] = host_split(
        lambda: ray_coherence_key(r.origin, r.direction), floors)
    del packed, rays, stages, raw, unsorted, srt, tracer, r

    # 14c: config 4's frame.
    fns_c, rays_c = prefit.stages(dev)
    hits, scene_f, packed_f = fns_c["fused"]()
    scene_s = fns_c["refit"]()
    packed_s = fns_c["repack"]()
    tables_equal(scene_f, scene_s, "14c fused/refit",
                 ("node_min", "node_max", "bin_min", "bin_max", "leaf_min",
                  "leaf_max", "tri_v", "bounds_min", "bounds_max"))
    tables_equal(packed_f, packed_s, "14c fused/repack")
    bits_same(hits, fns_c["trace"](), "14c fused/trace")
    rec_c = {"rays": rays_c["trace"], "hits": int(hits.hit.sum()),
             "refit_rows": prefit.refit_rows(fns_c, scene_s, packed_s),
             "stages": {}}
    for name, fn in fns_c.items():
        ms = prefit.timeit(fn, iters=prefit.ITERS.get(name, 10)) * 1e3
        rec_c["stages"][name] = {
            "ms": ms, **({"mrays_s": rays_c[name] / ms / 1e3}
                         if name in rays_c else {}),
            **host_split(fn, floors)}
    return rec_a, rec_b, rec_c, launches, row


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device; none found")
    import rtk_tpu_torch as rt
    from rtk_tpu_torch.ops import library, packet_trace
    from rtk_tpu_torch.ops.packet_trace import (trace_packets,
                                                trace_packets_reference)
    from rtk_tpu_torch.testing import scenes
    from rtk_tpu_torch.trace.packed import pack_scene
    from rtk_tpu_torch.utils.native_sah import NativeOracle

    dev = torch.device("cuda")
    card = smi("name,power.limit")
    t_start = time.perf_counter()
    launch_log = LaunchLog(packet_trace)

    def stamp():
        """{"card", "elapsed_s"}: the tail of every phase's line."""
        return {"card": card,
                "elapsed_s": round(time.perf_counter() - t_start, 1)}

    # ---- phase 1: build and environment ----
    # The kernel and one filter build per phase-6 predicate, one nvcc
    # each, all started together.
    filters = {name: rt.jit_filter(f) for name, f in (
        ("odd_tri", ODD_TRI), ("even_ray", EVEN_RAY), ("tri_t", TRI_T))}
    # The profiling tool that holds the dispatch probe's binding (phase 14);
    # its library is built beside them.
    ptrace = load_tool("torch_profile_trace")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=5) as pool:
        probe_build = pool.submit(ptrace.probe_library)
        list(pool.map(library.load_kernel, (None, *filters.values())))
        probe_build.result()
    build_s = time.perf_counter() - t0
    nvcc = subprocess.run([library._nvcc(), "--version"], check=True,
                          capture_output=True, text=True).stdout

    def ptxas(key):
        """ptxas -v's registers, frame and spills per instantiation: w8,
        w16 and (without a filter) w8_march, and per kernel of the
        coherence key, the unsort, the refit, the repack and the candidate
        slab (nearest_boxes<K>)."""
        out, name = {}, None
        for ln in library.BUILD_LOGS[key].splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", ln)
            if m:
                w = re.search(r"ILi(\d+)ELb([01])E", m.group(1))
                name = (f"w{w.group(1)}" + ("_march" if w.group(2) == "1"
                                            else "") if w else
                        next((k for k in ("origin_bounds", "probe_bounds",
                                          "morton_key", "unsort_outputs",
                                          "refit_parents", "refit_leaves",
                                          "refit_slots", "repack")
                              if k in m.group(1)), None))
                k = re.search(r"nearest_boxesILi(\d+)E", m.group(1))
                if k:
                    name = f"nearest_boxes<{k.group(1)}>"
            elif name and ("registers" in ln or "spill" in ln):
                out.setdefault(name, []).append(
                    ln.split("ptxas info    : ")[-1].strip())
        return out

    builds = {"plain_build": {"s": packet_trace.BUILD_SECONDS[None],
                              "ptxas": ptxas(None)}}
    for name, flt in filters.items():
        builds[name] = {"s": packet_trace.BUILD_SECONDS[flt.key],
                        "ptxas": ptxas(flt.key)}
    builds["dispatch_probe"] = {"s": ptrace.BUILD_SECONDS}
    print("phase 1 build:", json.dumps({
        "nvcc": [ln for ln in nvcc.splitlines() if "release" in ln][0],
        "torch": torch.__version__, "cuda": torch.version.cuda,
        "card": card, "all_builds_s": round(build_s, 3),
        "builds": builds}), flush=True)

    # ---- phase 2: kernel vs plain version at test shapes ----
    v6, f6 = scenes.blob(6)[1:]
    check(f6.shape[0] == 81920, "blob(6) must have 81,920 triangles")
    cornell = scenes.cornell_box()
    cornell_soup = (cornell.reshape(-1, 3),
                    np.arange(cornell.shape[0] * 3).reshape(-1, 3))
    cam512 = scenes.camera_rays(**CAM, width=512, height=512, order="morton",
                                device=dev)
    cases = [("cornell64", cornell_soup, scenes.cornell_camera(64, 64,
                                                               device=dev)),
             ("blob6_512", (v6, f6), cam512)]
    max_err = 0.0
    p2 = {}
    for name, mesh, rays in cases:
        n_tris = mesh[1].shape[0]
        mask = (np.arange(n_tris) % 2 + 1).astype(np.uint32)
        tables = {
            "lbvh4": pack_scene(rt.build_scene(mesh, device=dev),
                                tri_mask=mask),
            "sahq16": rt.build_sah_packed(mesh, rt.BuildConfig(leaf_size=16),
                                          tri_mask=mask, step_quant=True,
                                          device=dev)}
        for topo, packed in tables.items():
            for mode_name, kw in (("closest", {}), ("any", {"mode": "any"}),
                                  ("mask", {"filter_mask": 1}),
                                  ("defer_uv", {"defer_uv": True})):
                what = f"{name}/{topo}/{mode_name}"
                got, k_ms = timed(lambda: trace_packets(packed, rays, **kw),
                                  reps=3)
                want, p_ms = timed(
                    lambda: trace_packets_reference(packed, rays, **kw),
                    warm=False)
                max_err = max(max_err, compare(got, want, what))
                # The bound of this trace, from its own per-ray pops.
                b_ms, b_by = bound(trace_packets(packed, rays, **kw,
                                                 stats=True)[1], packed)
                p2[what] = {"ms": round(k_ms, 4), "plain_ms": round(p_ms, 2),
                            "hits": int(got.hit.sum()), "bound_ms": b_ms,
                            "bound_by": b_by}
    print("phase 2 kernel==plain:", json.dumps(
        {"max_abs_err": max_err, "traces": p2, **stamp()}), flush=True)

    # ---- phase 3: the main path at full size ----
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    scene = rt.build_scene((v6, f6), device=dev)
    tracer = rt.Tracer(scene)
    packed = tracer.packed
    torch.cuda.synchronize()
    build_ms = (time.perf_counter() - t0) * 1e3
    rays = scenes.camera_rays(**CAM, width=8192, height=8192,
                              order="morton", device=dev, on_device=True)
    n = rays.count
    torch.cuda.synchronize()
    packet_trace.KERNEL_LAUNCHES = packet_trace.ANY_LAUNCHES = 0
    packet_trace.KEY_LAUNCHES = packet_trace.UNSORT_LAUNCHES = 0
    packet_trace.ROWS_LAUNCHES = 0
    start, mid, end = (torch.cuda.Event(enable_timing=True)
                       for _ in range(3))
    launch_log.start(3)
    start.record()
    hits = tracer.closest(rays)
    mid.record()
    occ = tracer.any(rays)
    end.record()
    torch.cuda.synchronize()
    launch_log.stop()
    launches = packet_trace.KERNEL_LAUNCHES
    any_launches = packet_trace.ANY_LAUNCHES
    key_launches = packet_trace.KEY_LAUNCHES
    unsort_launches = packet_trace.UNSORT_LAUNCHES
    rows_launches = packet_trace.ROWS_LAUNCHES
    closest_ms = start.elapsed_time(mid)
    any_ms = mid.elapsed_time(end)
    check(launches >= 2, f"main path launched the kernel {launches} times")
    check(key_launches >= 2, f"main path launched the coherence key's "
          f"kernels {key_launches} times")
    check(unsort_launches >= 2, f"main path launched the unsort "
          f"{unsort_launches} times")
    check(rows_launches >= 2, f"main path launched the rows pass "
          f"{rows_launches} times")
    n_hit = int(hits.hit.sum())
    check(abs(n_hit - HEADLINE_EXPECT_HITS) <= HEADLINE_HIT_TOL,
          f"8192^2 hit count {n_hit} vs expected {HEADLINE_EXPECT_HITS}")
    check(torch.equal(occ.hit, hits.hit), "any-hit mask != closest mask")
    check(bool(torch.isfinite(hits.t[hits.hit]).all()), "non-finite hit t")
    # Steady state of the same call, and the kernel alone vs its plain
    # version on the same sorted rays (these launches are not counted).
    _, steady_ms = timed(lambda: tracer.closest(rays), reps=3)
    from rtk_tpu_torch.ops import morton
    key, key_ms = timed(lambda: morton.ray_coherence_key(rays.origin,
                                                         rays.direction),
                        reps=3)
    order, sort_ms = timed(lambda: torch.sort(key, stable=True).indices,
                           reps=3)
    key_dtype = str(key.dtype)
    # The coherence key's kernels alone: beside the eager plain version on
    # the card at 8192^2, and held against the plain version on a CPU copy
    # at 1024^2 (phase 7 holds them on the atrium bounce).
    plain_key, key_plain_ms = timed(
        lambda: morton.ray_coherence_key_reference(rays.origin,
                                                   rays.direction),
        warm=False)
    key_rec = {"ms_8192": key_ms, "plain_ms_8192": key_plain_ms,
               "cuda_plain_differ_8192": int((key != plain_key).sum())}
    del plain_key
    r1024 = scenes.camera_rays(**CAM, width=1024, height=1024,
                               order="morton", device=dev, on_device=True)
    _, key_rec["ms_1024"] = timed(lambda: morton.ray_coherence_key(
        r1024.origin, r1024.direction), reps=20)
    key_rec["primaries_1024"] = key_check(morton, r1024, "1024^2 primaries")
    # The rows pass alone (csrc/ray_rows.cu) through the sort's order,
    # beside its plain version on the card (the stacking and the gather it
    # replaces) and bit-equal to it; unsorted, beside the stacking alone;
    # and sorted at 1024^2.
    order_1024 = torch.sort(morton.ray_coherence_key(
        r1024.origin, r1024.direction), stable=True).indices
    parts_1024 = (r1024.origin, r1024.direction, r1024.min_t, r1024.max_t)
    _, rows_ms_1024 = timed(lambda: packet_trace.ray_rows_kernel(
        *parts_1024, order_1024), reps=20)
    del r1024, order_1024, parts_1024
    parts = (rays.origin, rays.direction, rays.min_t, rays.max_t)
    comps, rows_ms = timed(
        lambda: packet_trace.ray_rows_kernel(*parts, order), reps=3)
    rows_want, rows_plain_ms = timed(
        lambda: packet_trace.ray_rows_reference(*parts, order), reps=3)
    check(bits_equal(comps, rows_want), "main path rows pass/plain differ")
    del rows_want
    flat, rows_flat_ms = timed(lambda: packet_trace.ray_rows_kernel(*parts),
                               reps=3)
    flat_want, rows_flat_plain_ms = timed(
        lambda: packet_trace.ray_rows_reference(*parts), reps=3)
    check(bits_equal(flat, flat_want), "unsorted rows pass/plain differ")
    del flat, flat_want, key
    rows_rec = {"bytes_per_ray": ROWS_BYTES_PER_RAY
                - 12 * (rays.origin.stride(0) == 0),
                "ms_8192": rows_ms, "plain_ms_8192": rows_plain_ms,
                "unsorted_ms_8192": rows_flat_ms,
                "unsorted_plain_ms_8192": rows_flat_plain_ms,
                "ms_1024": rows_ms_1024}
    kw = dict(leaf_size=packed.leaf_size, stack_size=packed.stack_size)
    k_out, kernel_ms = timed(
        lambda: packet_trace.packet_trace_kernel(packed.nodes, packed.tris,
                                                 comps, **kw), reps=3)
    p_out, plain_ms = timed(
        lambda: packet_trace.packet_trace_reference(packed.nodes,
                                                    packed.tris, comps, **kw),
        warm=False)
    main_err = compare(as_hits(k_out), as_hits(p_out),
                       "main path kernel/plain")
    max_err = max(max_err, main_err)
    # The unsort alone on those outputs, against its plain version (the
    # index-puts) on the card, bit for bit.
    u_out, unsort_ms = timed(lambda: packet_trace.unsort_kernel(k_out, order),
                             reps=3)
    u_want, unsort_plain_ms = timed(
        lambda: packet_trace.unsort_reference(k_out, order), reps=3)
    check(all(bits_equal(a, b) for a, b in zip(u_out, u_want)),
          "main path unsort kernel/plain differ")
    del order, u_out, u_want, p_out
    main_bound = bound(packet_trace.packet_trace_kernel(
        packed.nodes, packed.tris, comps, **kw, stats=True)[4], packed)
    # The any-hit launch of the main path alone, with its own bound.
    _, any_kernel_ms = timed(
        lambda: packet_trace.packet_trace_kernel(
            packed.nodes, packed.tris, comps, **kw, mode="any"), reps=3)
    any_bound = bound(packet_trace.packet_trace_kernel(
        packed.nodes, packed.tris, comps, **kw, mode="any",
        stats=True)[4], packed)
    print("phase 3 main path:", json.dumps({
        "rays": n, "hits": n_hit, "expect": HEADLINE_EXPECT_HITS,
        "build_ms": round(build_ms, 1), "packed_depth": packed.depth,
        "closest_ms": round(closest_ms, 2), "any_ms": round(any_ms, 2),
        "steady_closest_ms": round(steady_ms, 2),
        "closest_mrays_s": round(n / steady_ms / 1e3, 2),
        "kernel_ms": round(kernel_ms, 2), "plain_ms": round(plain_ms, 1),
        "key_ms": round(key_ms, 2), "sort_ms": round(sort_ms, 2),
        "key_dtype": key_dtype, "key": key_rec, "key_launches": key_launches,
        "unsort_ms": unsort_ms, "unsort_plain_ms": unsort_plain_ms,
        "unsort_launches": unsort_launches, "rows": rows_rec,
        "rows_launches": rows_launches,
        "kernel_launches": launches, "max_abs_err": main_err,
        "bound_ms": main_bound[0], "bound_by": main_bound[1],
        "any_kernel_ms": round(any_kernel_ms, 2),
        "any_bound_ms": any_bound[0], "any_bound_by": any_bound[1],
        "peak_gib": launch_log.peak_gib(), **stamp()}), flush=True)
    del hits, occ, comps, k_out, rays

    # ---- phase 4: record parity against the C++ oracle ----
    sah = rt.build_sah_packed((v6, f6), rt.BuildConfig(leaf_size=16),
                              step_quant=True, device=dev)
    hl = trace_packets(sah, cam512, sort_rays=False, dual=True, ordered=True,
                       defer_uv=True, leaf_loop=True, kz_static=2)
    soup = rt.mesh.build_soup((v6, f6))
    orc = NativeOracle(soup.tri_pos.reshape(-1, 9), leaf_max=16,
                       step_quant=True)
    ot, ou, ov, oidx = orc.trace(*(getattr(cam512, f).cpu().numpy() for f in
                                   ("origin", "direction", "min_t", "max_t")))
    gh, oh = hl.hit.cpu().numpy(), oidx >= 0
    both = gh & oh
    hit_mism = int((gh != oh).sum())
    t_bad = int((np.abs(hl.t.cpu().numpy()[both] - ot[both]) > 1e-4).sum())
    same = both & (hl.triangle_index.cpu().numpy() == oidx)
    same_frac = float(same.sum() / max(both.sum(), 1))
    gu, gv = hl.u.cpu().numpy(), hl.v.cpu().numpy()
    uv_bad = int(((np.abs(gu[same] - ou[same]) > 1e-3)
                  | (np.abs(gv[same] - ov[same]) > 1e-3)).sum())
    ok = (hit_mism <= gh.size * 1e-4 and t_bad <= both.sum() * 1e-4
          and same_frac > 0.95 and uv_bad <= same.sum() * 1e-4)
    print(f"phase 4 record parity [sahq16 vs C++ oracle, 512^2]: "
          f"{'OK' if ok else 'FAIL'} (hit mism {hit_mism}/{gh.size}, "
          f"t bad {t_bad}, prim same {same_frac:.4f}, uv bad {uv_bad})",
          flush=True)
    check(ok, "record parity failed")
    del sah, hl

    # ---- phase 5: the instanced path at BASELINE config 5 ----
    p5, inst5 = phase5(rt, dev, launch_log)
    check(p5["launches"]["roots"] > 0,
          "the instanced path never launched the roots variant")
    print("phase 5 instanced:", json.dumps({**p5, **stamp()}),
          flush=True)

    # ---- phase 6: filtered queries and per-ray statistics ----
    p6, p6_kernels = phase6(rt, dev, launch_log, v6, f6, cam512)
    print("phase 6 filter/stats:", json.dumps({**p6, **stamp()}),
          flush=True)

    # ---- phase 7: 16-wide tables and the grid march at full width ----
    p7, p7_kernels = phase7(rt, dev, launch_log, v6[f6], cam512)
    check(p7_kernels["packet_trace_w16"]["launches"] >= 2,
          "phase 7 never launched the 16-wide instantiation")
    print("phase 7 w16/march:", json.dumps({
        **p7, "shapes": "w16 kernel and plain ms and bound at 8192^2 "
        "(sort_rays=False rows), both modes' counts at 512^2; march kernel "
        "and plain ms and bound on the 1024^2 atrium bounce, both modes' "
        "counts on a 256^2 subset of it", **stamp()}), flush=True)

    # ---- phase 8: dynamic scenes (refit, repack, trace) ----
    p8, p8_kernels = phase8(rt, dev, launch_log)
    p8_kernels["packet_trace_any"]["launches"] += any_launches
    for name, k in p8_kernels.items():
        check(k["launches"] > 0, f"phase 8 never launched {name}")
    print("phase 8 dynamic scenes:", json.dumps({**p8, **stamp()}),
          flush=True)

    # ---- phase 9: the render path ----
    p9, p9_launches, p9_errs = phase9(rt, dev, launch_log, inst5)
    # Phase 11 shards phase 5's LBVH forest and rays.
    inst11 = SimpleNamespace(ps=inst5.tables["lbvh8"], rays=inst5.rays)
    del inst5
    for part, title in (("9a", "render_path, atrium"),
                        ("9b", "render_direct and render_ao, atrium"),
                        ("9c", "4-bounce instanced wavefront, config 5")):
        print(f"phase {part} {title}:", json.dumps({**p9[part], **stamp()}),
              flush=True)
    check(all(v > 0 for v in p9_launches.values()),
          f"phase 9 launches {p9_launches}")
    launches += p9_launches["kernel"]
    max_err = max(max_err, p9_errs["kernel"])
    p5["launches"]["roots"] += p9_launches["roots"]
    p5["max_abs_err"] = max(p5["max_abs_err"], p9_errs["roots"])
    p8_kernels["packet_trace_any"]["max_abs_err"] = max(
        p8_kernels["packet_trace_any"]["max_abs_err"], p9_errs["any"])
    for name in ("any", "defer_uv"):
        p8_kernels[f"packet_trace_{name}"]["launches"] += p9_launches[name]
    p6_kernels["packet_trace_stats"]["launches"] += p9_launches["stats"]
    p7_kernels["packet_trace_march"]["launches"] += p9_launches["march"]

    # ---- phase 10: the Tracer's remaining engines ----
    p10, p10_launches, p10_errs = phase10(rt, dev, launch_log)
    print("phase 10 remaining engines:", json.dumps({**p10, **stamp()}),
          flush=True)
    launches += p10_launches["kernel"]
    max_err = max(max_err, p10_errs["kernel"])
    p5["launches"]["roots"] += p10_launches["roots"]
    p5["max_abs_err"] = max(p5["max_abs_err"], p10_errs["roots"])
    for name in ("any", "mask"):
        k = p8_kernels[f"packet_trace_{name}"]
        k["launches"] += p10_launches[name]
        k["max_abs_err"] = max(k["max_abs_err"], p10_errs[name])

    # ---- phase 11: ray, scene and hybrid sharding ----
    p11, p11_launches, packed6 = phase11(rt, dev, launch_log, inst11)
    del inst11
    print("phase 11 sharding:", json.dumps({**p11, **stamp()}), flush=True)
    launches += p11_launches["kernel"]
    p5["launches"]["roots"] += p11_launches["roots"]
    p8_kernels["packet_trace_any"]["launches"] += p11_launches["any"]

    # ---- phase 12: serving from AOT artifacts with no nvcc ----
    p12, p12_launches = phase12(rt, dev, launch_log, packed6)
    del packed6
    print("phase 12 aot serving:", json.dumps({**p12, **stamp()}),
          flush=True)
    launches += p12_launches["kernel"]

    # ---- phase 13: the cost model against a cut sweep ----
    p13, p13_launches, p13_err = phase13(rt, dev, launch_log, v6, f6)
    print("phase 13 costmodel:", json.dumps({**p13, **stamp()}), flush=True)
    launches += p13_launches["kernel"]
    key_launches += p13_launches["key"]
    unsort_launches += p13_launches["unsort"]
    max_err = max(max_err, p13_err)
    p6_kernels["packet_trace_stats"]["launches"] += p13_launches["stats"]

    # ---- phase 14: the profiling entry points ----
    p14a, p14b, p14c, p14_launches, probe_row = phase14(
        rt, dev, ptrace, load_tool("torch_profile_refit"), v6, f6)
    check(p14_launches > 0, "phase 14 never launched the dispatch probe")
    big = p13["sizes"][1024]
    p14a["beside_phase13"] = {
        "host_floor_us": p14a["host_floor_us"],
        "p13_fixed_ms": p13["fixed_ms"],
        "p13_wall_ms_1024": big["wall_ms"], "p13_rel_err_1024": big["rel_err"]}
    for part, title, rec in (
            ("14a", "dispatch probe and launch floors", p14a),
            ("14b", "profile_trace stages, blob(6) 1024^2", p14b),
            ("14c", "profile_refit stages, config 4", p14c)):
        print(f"phase {part} {title}:", json.dumps({**rec, **stamp()}),
              flush=True)

    src = "rtk_tpu_torch/csrc/packet_trace.cu"
    kernels = [
        {"name": "packet_trace", "replaces": "rtk_tpu/ops/pallas_trace.py:146",
         "launches": launches, "max_abs_err": max_err, "ms": kernel_ms,
         "plain_ms": plain_ms, "bound_ms": main_bound[0],
         "bound_by": main_bound[1],
         "bounce8": p7["atrium"]["k1_bounce8"]},
        {"name": "packet_trace_any",
         "replaces": "rtk_tpu/ops/pallas_trace.py:450",
         **p8_kernels["packet_trace_any"]},
        {"name": "packet_trace_mask",
         "replaces": "rtk_tpu/ops/pallas_trace.py:997",
         **p8_kernels["packet_trace_mask"]},
        {"name": "packet_trace_defer_uv",
         "replaces": "rtk_tpu/ops/pallas_trace.py:1019",
         **p8_kernels["packet_trace_defer_uv"]},
        {"name": "packet_trace_roots",
         "replaces": "rtk_tpu/ops/pallas_trace.py:347",
         "launches": p5["launches"]["roots"],
         "max_abs_err": p5["max_abs_err"], "ms": p5["kernel_ms"],
         "plain_ms": p5["plain_ms"], "bound_ms": p5["bound_ms"],
         "bound_by": p5["bound_by"],
         "shape": f"round 0 of config 5, LBVH forest: {p5['round0_rays']} "
                  "rays grouped by instance as the rounds launch them; the "
                  "launch alone, its roots checked once before"},
        {"name": "packet_trace_filter",
         "replaces": "rtk_tpu/ops/pallas_trace.py:1003",
         **p6_kernels["packet_trace_filter"]},
        {"name": "packet_trace_stats",
         "replaces": "rtk_tpu/ops/pallas_trace.py:514",
         **p6_kernels["packet_trace_stats"]},
        {"name": "packet_trace_w16",
         "replaces": "rtk_tpu/ops/pallas_trace.py:163",
         **p7_kernels["packet_trace_w16"]},
        {"name": "packet_trace_march",
         "replaces": "rtk_tpu/ops/pallas_trace.py:387",
         **p7_kernels["packet_trace_march"]}]
    # Each row's launches replayed alone: the sum of (ms - bound) at each
    # launch's own shape, from the launches its `launches` counts.
    rows_of_log = {"packet_trace": ((3, 9, 10, 11, 12, 13), None),
                   "packet_trace_any": ((3, 8, 9, 10, 11), "any"),
                   "packet_trace_mask": ((8, 10), "mask"),
                   "packet_trace_defer_uv": ((8, 9), "defer_uv"),
                   "packet_trace_roots": ((5, 9, 10, 11), "roots"),
                   "packet_trace_filter": ((6,), "filter"),
                   "packet_trace_stats": ((6, 9, 13), "stats"),
                   "packet_trace_w16": ((7,), "w16"),
                   "packet_trace_march": ((7, 9), "march")}
    for k in kernels:
        n_l, l_ms, l_bound, gap = launch_log.row(*rows_of_log[k["name"]])
        check(n_l == k["launches"], f"{k['name']}: {n_l} launches replayed, "
              f"{k['launches']} counted")
        k.update(gap_ms=gap, launches_ms=l_ms, launches_bound_ms=l_bound)
    # The coherence key: the port's own kernels (the reference computes the
    # key in XLA, outside any Pallas kernel).  No single PyTorch call
    # computes it, so library_ms is null.
    n_head = 8192 * 8192
    t_bytes = KEY_BYTES_PER_RAY * n_head / PEAK_BYTES * 1e3
    t_ops = KEY_OPS_PER_RAY * n_head / PEAK_F32_INSTR * 1e3
    key_row = {
        "name": "coherence_key", "route": "cuda",
        "source": "rtk_tpu_torch/csrc/coherence_key.cu",
        "replaces": "rtk_tpu/ops/morton.py:61", "launches": key_launches,
        "max_abs_err": max(key_rec["primaries_1024"]["max_abs_err"],
                           p7["key_bounce"]["max_abs_err"]),
        "ms": key_rec["ms_8192"], "ms_1024": key_rec["ms_1024"],
        "plain_ms": key_rec["plain_ms_8192"],
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None,
        "shape": "8192^2 Morton primaries of the headline camera (ms, "
                 "plain_ms: the eager plain version on the card, bound); "
                 "ms_1024 at 1024^2; keys bit-equal to the plain version "
                 "on a CPU copy at 1024^2 and on the atrium bounce; the "
                 "reference computes the key outside any Pallas kernel"}
    unsort_row = {
        "name": "unsort", "route": "cuda",
        "source": "rtk_tpu_torch/csrc/unsort.cu",
        "replaces": "rtk_tpu/ops/pallas_trace.py:1534",
        "launches": unsort_launches, "max_abs_err": 0.0, "ms": unsort_ms,
        "plain_ms": unsort_plain_ms,
        "bound_ms": UNSORT_BYTES_PER_RAY * n_head / PEAK_BYTES * 1e3,
        "bound_by": "bytes", "library_ms": None,
        "shape": "phase 3's 8192^2 kernel outputs (t, u, v, slot) and "
                 "sort order; plain_ms: the four index-puts it replaces, "
                 "bit-equal; no one PyTorch call moves the four outputs; "
                 "the reference unsorts by a multi-operand XLA sort outside "
                 "any Pallas kernel"}
    rows_row = {
        "name": "ray_rows", "route": "cuda",
        "source": "rtk_tpu_torch/csrc/ray_rows.cu",
        "replaces": "rtk_tpu/ops/pallas_trace.py:1452",
        "launches": rows_launches, "max_abs_err": 0.0,
        "ms": rows_rec["ms_8192"], "ms_1024": rows_rec["ms_1024"],
        "plain_ms": rows_rec["plain_ms_8192"],
        "bound_ms": rows_rec["bytes_per_ray"] * n_head / PEAK_BYTES * 1e3,
        "bound_by": "bytes", "library_ms": None,
        "shape": "phase 3's 8192^2 rays through their sort order (ms_1024: "
                 "the 1024^2 primaries; the bound at bytes_per_ray, the "
                 "camera's origin read in place); plain_ms: the stacking and the "
                 "gather it replaces, bit-equal; no one PyTorch call stacks "
                 "and gathers; the reference stacks inside its jitted "
                 "program in XLA, outside any Pallas kernel"}
    # The shade pass of render_path (the reference's is an XLA fusion under
    # jit, no Pallas kernel): ms, plain_ms and bound_ms are the means over
    # 9a's four bounce batches that are not the last.
    sh = p9["9a"]["shade"]
    shade_row = {
        "name": "shade", "route": "cuda",
        "source": "rtk_tpu_torch/csrc/shade.cu",
        "replaces": "rtk_tpu/models/path.py:98",
        "launches": p9_launches["shade"], "max_abs_err": sh["max_abs_err"],
        "ms": sh["ms"], "plain_ms": sh["plain_ms"], "bound_ms": sh["bound_ms"],
        "bound_by": "bytes", "library_ms": None,
        "shape": "9a's atrium frame, 1024^2 compacted and sorted bounce "
                 f"batches with the uniforms handed in ({SHADE_BYTES_PER_RAY} "
                 "bytes a ray); plain_ms: the eager pass and the uniforms' "
                 "gather it replaces, bit-equal on every output; no one "
                 "PyTorch call shades; the reference shades inside its "
                 "jitted loop in XLA, outside any Pallas kernel"}
    # A deforming frame's refit and repack (the reference refits in XLA
    # under jit, no Pallas kernel; no one PyTorch call refits): phase 8's
    # rows, the plain versions the eager ops they replace.
    refit_rows = [
        {"name": name, "route": "cuda",
         "source": "rtk_tpu_torch/csrc/refit.cu",
         "replaces": "rtk_tpu/scene.py:314", "library_ms": None,
         **p8_kernels[name]} for name in ("refit", "repack")]
    # No PyTorch call traverses a BVH: library_ms is null for every
    # traversal entry.
    print(json.dumps({"kernels": [
        {"route": "cuda", "source": src, "library_ms": None, **k}
        for k in kernels] + [key_row, rows_row, unsort_row, shade_row,
                             *refit_rows, probe_row]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())

"""Time builds of rtk_tpu_torch's traversal kernel against each other on one
CUDA card, with what the compiler made of each.

    python3 tools/torch_kernel_ladder.py [--source [LABEL=]PATH]... [--variant [LABEL:]NAME=FLAGS]... [--batches atrium,render] [--pairs 20]

Each --source is a copy of csrc/packet_trace.cu with the same C interface
(default: the package's own; e.g. `parent=` a checkout of another commit
beside `tree=` this one's); each --variant is a name and extra nvcc
flags (`base=`, `sort=-DK1_SORT`), built from every source, or from the
source LABEL only when given as `LABEL:NAME=FLAGS`, so a source that
switches its changes on preprocessor macros gives a ladder of builds.  Every (source, variant)
is built twice, plain and with the odd-triangle filter predicate, and:

  * ptxas -v's registers, frame and spills per instantiation are printed;
  * `cuobjdump -sass` of each build is written to
    rtk_tpu_torch/build/ladder/, and per kernel the instruction count, a
    digest of the listing (two builds with one digest run the same code),
    the counts of LDL/STL/LDG and the loops (backward branches with their
    lengths) go to --out/ladder.jsonl (default rtk_tpu_torch/build/
    ladder/), which holds every record in full; the standard output gets
    registers, spills, instruction and LDL/STL counts, digests and median
    times;
  * the kernel alone is timed with CUDA events on these batches (--batches:
    the headline and those named, default all):
    - "headline": the main path's rows at --width^2 (default 8192):
      blob(6), LBVH leaf 4, morton camera rays in coherence-key order.
      Modes: closest, any, mask, defer_uv, stats, and the filter build
      with ray_index;
    - "grid8b": chip_smoke.py phase 8b's rows: deforming_grid(n=1024)
      (2,097,152 triangles) on LBVH leaf-8 tables refit to t = 0.2, 2048^2
      morton camera rays unsorted; defer_uv (the rows phase 8b times),
      closest, any and mask (the odd/even tri_mask, qmask 1: phase 8b's
      mask row), so that the mask is timed beside the same trace
      without it;
    - "grid8b_sah": the same rays on the grid at t = 0.2 through one SAH
      tree (NativeOracle, leaf_max 8) packed 8 and 16 wide ("w8",
      "w16"): 16-wide tables past L2;
    - "roots": BASELINE config 5's round 0 (chip_smoke.py phase 5, LBVH
      forest): every ray with a candidate in its first candidate's object
      space from that instance's BLAS root, grouped by instance as
      instancing.trace_closest_instanced_packets launches it ("roots"),
      and in world Morton order, as the smoke's roots row was timed
      before it followed the rounds ("roots_world");
    - "w16": chip_smoke.py phase 7's 16-wide headline: one SAH tree of
      blob(6) (leaf 16) packed 16 wide, --width^2 morton rays unsorted;
    - "atrium": phase 7's atrium bounce (1024^2 primaries on SAH leaf-16
      tables, one cosine-sampled bounce, coherence-sorted) through the
      8- and 16-wide tables, through the flat LBVH (leaf 16) tables of
      the march's scene ("lbvh", the march's yardstick), and through the
      grid march on the atrium's LBVH (leaf 16) with march_batch's rows
      ("march") and grouped by (entry cell, octant) alone, march_batch's
      key before it took the direction inside the octant ("march_
      cellkey"); the same two for phase 7's march primaries, the 1024^2
      camera rays ("march_prim", "march_prim_cellkey"); and what each
      grouping costs ("grouping_ms");
    - "render": chip_smoke.py phase 9's atrium as four meshes (LBVH leaf
      16 through Tracer): 9b's shadow rays ("shadow", render_direct's
      any-hit batch) and its first AO probe ("ao", render_ao's first
      any-hit batch, max_dist 3) in the order trace_packets hands them
      to the kernel, and 9a's bounce 2 through the march ("march_b2",
      render_path with the march as bounce_tracer; "march_b2_cellkey"
      grouped by (entry cell, octant) alone);
    The builds run in turn, forwards then backwards, --rounds times; the
    minimum and median of the rounds are reported;
  * every output of every build (t, u, v, slot, counts) must equal the
    first build's bit for bit; each case's mixed-axis share (utils/
    stats.py: the 32-ray warps of its rows whose shear axes differ, which
    take the leaf test that reads the axis from the ray) is printed; the
    first build's per-ray counts are printed with their divergence (per
    32-ray warp, the mean of the warp's largest count over the mean
    count);
  * on every stats case, box tests per internal pop (n_box / n_int); on
    every mask batch (headline, grid8b), the masked-row share: 1 - sum
    n_tri / sum (n_leaf x leaf_size), the leaf loop's slots spent on rows
    never tested (rows the mask rejects and NaN padding);
  * on every any-hit batch (headline, grid8b, render shadow and ao), the
    idle-lane share: over the 32-ray warps, sum(32 x the warp's largest
    step count - the sum of its lanes' steps) / sum(32 x its largest),
    the instruction slots a warp spends on lanes whose ray has ended;
  * on every march batch (atrium march, render march_b2), from the plain
    version's rounds (round k traces each live ray's k-th cell, as
    packet_march_reference does, replayed here with stats): the cells a
    ray visits (mean, and a warp's largest over the mean), the empty
    cells among them (a root row with no child: no box test), and the
    per-cell barrier ratio: over the warps, the sum over k of the
    largest lane's steps in its k-th cell, over the sum of the warp's
    largest total of steps -- what a loop that waits for every lane to
    finish a cell pays over one that does not;
  * the grouping key end to end: Tracer(engine="march").closest on the
    atrium bounce and primaries with march_batch's key and with (entry
    cell, octant) alone, in --pairs pairs whose order alternates, 10
    calls a sample: each key's median and quartiles, and the pairs the
    shipped key won ("key_end_to_end"; the two keys' hits must be equal);
  * clocks.sm and power.draw are sampled by nvidia-smi while launches of
    the first build are queued, and the per-ray counts of the stats
    variant are printed, so the time the instruction stream needs if it
    never stalls (instructions a ray over 132 SMs x 4 schedulers x the
    clock) can be estimated from the SASS counts.
--pairs 0 leaves out the grouping key's end-to-end pairs.

One JSON object per line; needs a CUDA card and nvcc; imports no jax.
"""
import argparse
import ctypes
import hashlib
from concurrent.futures import ThreadPoolExecutor
import json
import pathlib
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

CAM = dict(eye=(0, 0, 3.0), look_at=(0, 0, 0), up=(0, 1, 0), fov_deg=45)
ODD_TRI = lambda c: c.triangle_index % 2 == 1  # noqa: E731
MODES = {"closest": {}, "any": {"mode_any": 1}, "mask": {"qmask": 1},
         "defer_uv": {"defer_uv": 1}, "stats": {"stats": True}}
# Timed launches of a batch per --reps: about 50 ms of kernel a round each.
COUNTS = ("steps", "internal_pops", "leaf_pops", "box_tests", "tri_tests")
REPS_SCALE = {"headline": 1, "grid8b": 12, "grid8b_sah": 12, "roots": 60,
              "w16": 1, "atrium": 12, "render": 12}
# The batches --batches can name (grid8b brings grid8b_sah).
BATCHES = ("grid8b", "roots", "w16", "atrium", "render")


def warp_view(c):
    """(..., N) per-ray counts as (..., warps, 32): the kernel's warps are
    32 consecutive rows; a ragged last warp is left out."""
    n = c.shape[-1] // 32 * 32
    return c[..., :n].reshape(*c.shape[:-1], -1, 32)


def idle_lane_share(steps):
    """sum over warps of (32 x largest - sum of lanes) / sum of 32 x
    largest, from per-ray step counts in the kernel's row order."""
    w = warp_view(steps.double())
    busy = 32 * w.amax(dim=-1)
    return float((busy - w.sum(dim=-1)).sum() / busy.sum().clamp_min(1))


def rows_of(o, d, mint, maxt):
    return torch.cat([o.T, d.T, mint[None], maxt[None]]).contiguous()


def cell_key_batch(grid, rays):
    """testing/grid.py's march_batch with its key before it took the
    direction inside the octant: (entry cell, octant) alone, rays that
    miss the grid last, stably -> (MarchGrid, rows, idx)."""
    from rtk_tpu_torch.ops import packet_trace as pt

    mg = pt.MarchGrid.of(grid.dims, grid.grid_lo, grid.cell_size,
                         grid.march_occ)
    rows = rows_of(rays.origin, rays.direction, rays.min_t,
                   rays.max_t).float()
    live, cell, *_ = pt.march_entry(rows, mg)
    _, ny, nz = mg.dims
    d = rows[3:6]
    octant = ((d[0] >= 0).long() * 4 + (d[1] >= 0).long() * 2
              + (d[2] >= 0).long())
    key = ((((cell[0] * ny + cell[1]) * nz + cell[2]) << 3) | octant)
    key = torch.where(live, key, torch.iinfo(torch.int64).max)
    idx = torch.sort(key, stable=True).indices
    return mg, rows[:, idx].contiguous(), idx


def quartiles(v):
    q = statistics.quantiles(v, n=4)
    return {"median": statistics.median(v), "q1": q[0], "q3": q[2]}


def key_end_to_end(march, batches, pairs, reps):
    """Tracer(engine="march").closest on each of `batches` with
    march_batch's key ("dir_key") and with cell_key_batch's ("cell_key"),
    testing/grid.py's march_batch swapped for the call, in `pairs` pairs
    whose order alternates; a sample is `reps` calls between CUDA events
    after a warm one.  The two keys' hits must be equal bit for bit.
    -> {batch: {key: quartiles of the samples, "pairs_won_by_dir_key"}}."""
    from rtk_tpu_torch.testing import grid as tgrid

    keys = {"dir_key": tgrid.march_batch, "cell_key": cell_key_batch}
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    out = {}
    try:
        for name, rays in batches.items():
            ms = {k: [] for k in keys}
            hits = {}
            for pair in range(pairs):
                for k in (list(keys) if pair % 2 == 0 else list(keys)[::-1]):
                    tgrid.march_batch = keys[k]
                    hits[k] = march.closest(rays)
                    torch.cuda.synchronize()
                    start.record()
                    for _ in range(reps):
                        march.closest(rays)
                    end.record()
                    torch.cuda.synchronize()
                    ms[k].append(start.elapsed_time(end) / reps)
            for f in ("hit", "slot", "t", "u", "v"):
                if not torch.equal(getattr(hits["dir_key"], f),
                                   getattr(hits["cell_key"], f)):
                    raise RuntimeError(f"{name}: the keys' {f} differ")
            out[name] = {**{k: quartiles(v) for k, v in ms.items()},
                         "pairs_won_by_dir_key": sum(
                             a < b for a, b in zip(ms["dir_key"],
                                                   ms["cell_key"])),
                         "all": ms}
    finally:
        tgrid.march_batch = keys["dir_key"]
    return out


def march_rounds(pt, cm, rows, grid):
    """The march's plain version round by round (packet_march_reference's
    loop: round k traces each live ray's k-th cell), closest-hit, with
    stats -> (summed (5, N) counts, per round (the rays that traced a
    cell, their steps in it, whether it was empty: a root row with no
    child, so no box test))."""
    n = rows.shape[1]
    dev = rows.device
    live, cell, tm, step, tdel = pt.march_entry(rows, grid)
    best = [rows[7].clone(), torch.zeros(n, device=dev),
            torch.zeros(n, device=dev),
            torch.full((n,), -1, dtype=torch.int32, device=dev)]
    counts = torch.zeros((5, n), dtype=torch.int32, device=dev)
    dims = torch.tensor(grid.dims, device=dev)[:, None]
    act = torch.nonzero(live).squeeze(1)
    rounds = []
    while act.numel():
        c = cell[:, act]
        sub = rows[:, act].clone()
        sub[7] = best[0][act]
        out = pt.packet_trace_reference(
            cm.nodes, cm.tris, sub, leaf_size=cm.leaf_size,
            stack_size=cm.stack_size, stats=True,
            roots=((c[0] * grid.dims[1] + c[1]) * grid.dims[2]
                   + c[2]).to(torch.int32))
        upd = out[3] >= 0
        for b, new in zip(best, out):
            b[act] = torch.where(upd, new, b[act])
        counts[:, act] += out[4]
        rounds.append((act, out[4][0], out[4][3] == 0))
        t3 = tm[:, act]
        exit_t = torch.minimum(t3[0], torch.minimum(t3[1], t3[2]))
        fin = best[0][act] <= exit_t
        act, t3 = act[~fin], t3[:, ~fin]
        mx = (t3[0] <= t3[1]) & (t3[0] <= t3[2])
        my = ~mx & (t3[1] <= t3[2])
        ax = torch.stack([mx, my, ~mx & ~my])
        cell[:, act] += torch.where(ax, step[:, act], 0)
        tm[:, act] = torch.where(ax, t3 + tdel[:, act], t3)
        c = cell[:, act]
        act = act[((c >= 0) & (c < dims)).all(dim=0)]
    return counts, rounds


def march_cells(counts, rounds):
    """Cells a ray visits, the empty ones among them and the per-cell
    barrier ratio, from march_rounds' output."""
    n = counts.shape[1]
    dev = counts.device
    cells = torch.zeros(n, dtype=torch.float64, device=dev)
    empty = torch.zeros(n, dtype=torch.float64, device=dev)
    barrier = torch.zeros(n // 32, dtype=torch.float64, device=dev)
    for act, steps, is_empty in rounds:
        k = torch.zeros(n, dtype=torch.float64, device=dev)
        k[act] = steps.double()
        cells[act] += 1
        empty[act] += is_empty.double()
        barrier += warp_view(k).amax(dim=-1)
    total = warp_view(counts[0].double()).amax(dim=-1)
    seen = cells > 0
    return {"rays_in_grid": int(seen.sum()),
            "cells_mean": float(cells[seen].mean()),
            "cells_warp_max_over_mean": float(
                warp_view(cells).amax(dim=-1).mean() / cells.mean()),
            "empty_cells_mean": float(empty[seen].mean()),
            "empty_share": float(empty.sum() / cells.sum()),
            "rounds": len(rounds),
            "barrier_ratio": float(barrier.sum() / total.sum()),
            "barrier_ratio_warp_mean": float(
                (barrier[total > 0] / total[total > 0]).mean())}


def sass_summary(text):
    """Per kernel of a cuobjdump -sass listing: instructions, a digest of
    the listing (equal digests: the same code), local and global memory
    instructions, the opcode histogram's head, and every loop as (first
    address, last address, instructions)."""
    out, name, rows = {}, None, []

    def close():
        if name is None or not rows:
            return
        ops = [op for _, op, _ in rows]
        hist = {}
        for op in ops:
            base = op.split(".")[0]
            hist[base] = hist.get(base, 0) + 1
        loops = []
        addr_index = {a: i for i, (a, _, _) in enumerate(rows)}
        for i, (a, op, rest) in enumerate(rows):
            m = re.search(r"\b0x([0-9a-f]+)\b", rest)
            if op.startswith("BRA") and m:
                target = int(m.group(1), 16)
                if target <= a and target in addr_index:
                    loops.append((hex(target), hex(a),
                                  i - addr_index[target] + 1))
        out[name] = {
            "instructions": len(ops),
            "digest": hashlib.sha1("\n".join(
                f"{op}{rest}" for _, op, rest in rows).encode()).hexdigest(),
            **{k: sum(o.startswith(k) for o in ops)
               for k in ("LDL", "STL", "LDG", "LDS", "STS", "BRA", "MUFU")},
            "top": dict(sorted(hist.items(), key=lambda kv: -kv[1])[:14]),
            "loops": loops}

    for ln in text.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            close()
            name, rows = m.group(1), []
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\d+\s+)?"
                     r"([A-Z][A-Z0-9_.]*)(.*?);", ln)
        if m and name:
            rows.append((int(m.group(1), 16), m.group(2), m.group(3)))
    close()
    return {kernel_name(k): v for k, v in out.items()}


def kernel_name(mangled):
    """w8, w16 or w8_march from a packet_trace_kernel<W, MARCH> symbol;
    others unchanged."""
    m = re.search(r"ILi(\d+)ELb([01])E", mangled)
    if not m:
        return mangled
    return f"w{m.group(1)}" + ("_march" if m.group(2) == "1" else "")


def ptxas_summary(log):
    out, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '?(\S*ILi\d+ELb\S*)", ln)
        if m:
            name = kernel_name(m.group(1))
        elif name and ("registers" in ln or "spill" in ln):
            out.setdefault(name, []).append(
                ln.split("ptxas info    : ")[-1].strip())
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", action="append", default=[])
    ap.add_argument("--variant", action="append", default=[])
    ap.add_argument("--width", type=int, default=8192)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--pairs", type=int, default=20)
    ap.add_argument("--batches", default=",".join(BATCHES),
                    help="comma-separated, of " + ", ".join(BATCHES))
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    chosen = set(filter(None, args.batches.split(",")))
    if chosen - set(BATCHES):
        ap.error(f"--batches: unknown {sorted(chosen - set(BATCHES))}")
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device; none found")

    import rtk_tpu_torch as rt
    from rtk_tpu_torch.ops import library
    from rtk_tpu_torch.ops import packet_trace as pt
    from rtk_tpu_torch.ops.morton import ray_coherence_key
    from rtk_tpu_torch.testing import scenes
    from rtk_tpu_torch.utils.build import BUILD_DIR, build_shared
    from rtk_tpu_torch.utils.stats import mixed_axis_share

    dev = torch.device("cuda")
    out_dir = pathlib.Path(args.out or BUILD_DIR / "ladder")
    out_dir.mkdir(parents=True, exist_ok=True)
    log = open(out_dir / "ladder.jsonl", "w")

    def emit(rec, short=None):
        """One JSON line to --out/ladder.jsonl and, or `short` in its
        place, to the standard output (a long run's first lines outlive a
        truncated console)."""
        line = json.dumps(rec)
        print(line if short is None else json.dumps(short), flush=True)
        log.write(line + "\n")
        log.flush()

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip()
    sources = [(s.split("=", 1)[0] if "=" in s else f"source{i}",
                pathlib.Path(s.split("=", 1)[-1]).resolve())
               for i, s in enumerate(args.source)] or [
                   ("", library.KERNEL_SRC)]
    variants = [v.split("=", 1) for v in args.variant] or [["tree", ""]]
    variants = [(n.split(":", 1) if ":" in n else [None, n]) + [f]
                for n, f in variants]

    # ---- builds: every (source, variant), plain and filter, in parallel ----
    flt = rt.jit_filter(ODD_TRI)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    header = BUILD_DIR / f"ladder-filter-{flt.key}.h"
    header.write_text(flt.source)
    cuobjdump = pathlib.Path(library._nvcc()).with_name("cuobjdump")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    jobs = []
    for si, (src_label, src) in enumerate(sources):
        for only, name, flags in variants:
            if only is not None and only != src_label:
                continue
            label = name if len(sources) == 1 else f"{src_label}:{name}"
            for kind, extra, deps in (
                    ("plain", [], []),
                    ("filter", ["-DRTK_FILTER", f"-I{library.CSRC}",
                                "-include", str(header)],
                     [library.FILTER_OPS, header])):
                jobs.append((label, src, flags, kind,
                             f"ladder{si}_{name}_{kind}",
                             [library._nvcc(), *library.NVCC_FLAGS,
                              *flags.split(), *extra], deps))

    def run_build(job):
        _, src, _, _, lib_name, command, deps = job
        t0 = time.perf_counter()
        so, build_log = build_shared(lib_name, [src], command, deps=deps)
        return so, build_log, time.perf_counter() - t0

    with ThreadPoolExecutor(max_workers=8) as pool:
        built = list(pool.map(run_build, jobs))
    builds, recs, takes_occ = [], {}, {}
    for (label, src, flags, kind, *_), (so, build_log, secs) in zip(jobs,
                                                                    built):
        sass = subprocess.run([str(cuobjdump), "-sass", str(so)],
                              check=True, capture_output=True,
                              text=True).stdout
        tag = label.replace("/", "_").replace(":", "_")
        (BUILD_DIR / "ladder").mkdir(parents=True, exist_ok=True)
        (BUILD_DIR / "ladder" / f"{tag}.{kind}.sass").write_text(sass)
        lib = ctypes.CDLL(str(so))
        lib.rtk_packet_trace.restype = i32
        lib.rtk_packet_trace.argtypes = [ptr] * 5 + [i32] * 8 + [ptr] * 6
        if kind == "plain":
            # Sources since the march took the grid's occupancy words
            # have one more pointer after the grid's floats.
            takes_occ[id(lib)] = "const void* occ" in src.read_text()
            lib.rtk_packet_march.restype = i32
            lib.rtk_packet_march.argtypes = (
                [ptr] * 3 + [i32] * 9 + [ctypes.c_float] * 9
                + [ptr] * (7 if takes_occ[id(lib)] else 6))
        rec = recs.setdefault(label, {"build": label, "source": str(src),
                                      "flags": flags})
        rec[kind] = {"s": round(secs, 2), "ptxas": ptxas_summary(build_log),
                     "sass": sass_summary(sass)}
        if kind == "plain":
            builds.append((label, {}))
        dict(builds)[label][kind] = lib
    for rec in recs.values():
        emit(rec, {"build": rec["build"], "flags": rec["flags"], **{
            kind: {"ptxas": rec[kind]["ptxas"], "sass": {
                k: {c: v[c] for c in ("instructions", "LDL", "STL")}
                | {"digest": v["digest"][:12]}
                for k, v in rec[kind]["sass"].items()}}
            for kind in ("plain", "filter")}})

    # ---- the batches: tables, rows and cases ----
    import chip_smoke as cs
    from rtk_tpu_torch import instancing
    from rtk_tpu_torch.scene import refit
    from rtk_tpu_torch.trace.packed import pack_binary_tree, repack_bounds
    from rtk_tpu_torch.utils.native_sah import NativeOracle

    # headline
    v6, f6 = scenes.blob(6)[1:]
    mask = np.where(np.arange(f6.shape[0]) % 2 == 1, 1, 2).astype(np.uint32)
    packed = rt.Tracer(rt.build_scene((v6, f6), device=dev),
                       tri_mask=mask).packed
    rays = scenes.camera_rays(**CAM, width=args.width, height=args.width,
                              order="morton", device=dev, on_device=True)
    order = torch.sort(ray_coherence_key(rays.origin, rays.direction),
                       stable=True).indices
    rows = rows_of(rays.origin, rays.direction, rays.min_t,
                   rays.max_t)[:, order].contiguous()
    ridx = order.to(torch.int32)
    del rays, order
    cases = [("headline", m, "plain", packed, rows, kw)
             for m, kw in MODES.items()]
    cases.append(("headline", "filter", "filter", packed, rows,
                  {"ray_index": ridx}))
    cases.append(("headline", "filter_stats", "filter", packed, rows,
                  {"ray_index": ridx, "stats": True}))
    cases.append(("headline", "any_stats", "plain", packed, rows,
                  {"mode_any": 1, "stats": True}))
    cases.append(("headline", "mask_stats", "plain", packed, rows,
                  {"qmask": 1, "stats": True}))

    # grid8b
    if "grid8b" in chosen:
        cfg = rt.BuildConfig(branching=8, leaf_size=8, wide_nodes=False)
        g0 = scenes.deforming_grid(0.0, n=1024)
        scene8 = rt.build_from_soup(g0, config=cfg, device=dev)
        p8 = rt.Tracer(scene8, tri_mask=np.where(
            np.arange(g0.shape[0]) % 2 == 1, 1, 2).astype(np.uint32)).packed
        g2 = scenes.deforming_grid(0.2, n=1024)
        p8 = repack_bounds(p8, refit(scene8, torch.as_tensor(g2,
                                                             device=dev)))
        del scene8, g0
        cam8 = scenes.camera_rays(**cs.GRID_CAM, width=2048, height=2048,
                                  order="morton", device=dev, on_device=True)
        rows8 = rows_of(cam8.origin, cam8.direction, cam8.min_t, cam8.max_t)
        del cam8
        for m in ("defer_uv", "closest", "stats", "any", "mask"):
            cases.append(("grid8b", m, "plain", p8, rows8, MODES[m]))
        cases.append(("grid8b", "any_stats", "plain", p8, rows8,
                      {"mode_any": 1, "stats": True}))
        cases.append(("grid8b", "mask_stats", "plain", p8, rows8,
                      {"qmask": 1, "stats": True}))

        # grid8b_sah: the same rows through one SAH tree at both widths
        tree = NativeOracle(g2.reshape(-1, 9), leaf_max=8).export_tree()
        for w in (8, 16):
            pw = pack_binary_tree(g2, *tree, leaf_size=8, branching=w,
                                  device=dev)
            cases.append(("grid8b_sah", f"w{w}", "plain", pw, rows8, {}))
            cases.append(("grid8b_sah", f"w{w}_stats", "plain", pw, rows8,
                          {"stats": True}))
        del tree, g2

    # roots: config 5's round 0
    if "roots" in chosen:
        _, _, iscene, tables = cs.config5(rt, dev)
        ps = tables["lbvh8"]
        del tables
        cam5 = scenes.camera_rays(**cs.INST_CAM, width=1024, height=1024,
                                  order="morton", device=dev, on_device=True)
        cand, _, _ = instancing._instance_candidates(iscene, cam5, 1)
        sel = torch.nonzero(cand[:, 0] >= 0).squeeze(1)
        inst = cand[sel, 0].long()
        for name, grouped in (("roots", True), ("roots_world", False)):
            s_, i_ = sel, inst
            if grouped:
                o_ = torch.sort(inst, stable=True).indices
                s_, i_ = sel[o_], inst[o_]
            o, d = instancing._object_rays(iscene.object_from_world[i_],
                                           cam5.origin[s_],
                                           cam5.direction[s_])
            r5 = rows_of(o, d, cam5.min_t[s_], cam5.max_t[s_])
            roots = ps.packed_roots[iscene.instance_blas[i_]].contiguous()
            cases.append(("roots", name, "plain", ps.packed, r5,
                          {"roots": roots}))
            cases.append(("roots", name + "_stats", "plain", ps.packed, r5,
                          {"roots": roots, "stats": True}))
        del cand, sel, inst, cam5, iscene

    # w16: phase 7's 16-wide headline
    if "w16" in chosen:
        tables, _ = cs.sah_widths(rt, dev, v6[f6])
        cam = scenes.camera_rays(**CAM, width=args.width, height=args.width,
                                 order="morton", device=dev, on_device=True)
        rows16 = rows_of(cam.origin, cam.direction, cam.min_t, cam.max_t)
        del cam
        cases.append(("w16", "closest", "plain", tables[16], rows16, {}))
        cases.append(("w16", "stats", "plain", tables[16], rows16,
                      {"stats": True}))
        del tables

    # atrium: phase 7's bounce at both widths and through the march
    from rtk_tpu_torch.testing.grid import march_batch

    marches = []
    atr = scenes.atrium() if chosen & {"atrium", "render"} else None
    if "atrium" in chosen:
        from rtk_tpu_torch.models.path import cosine_sample, geometric_normal

        tables, _ = cs.sah_widths(rt, dev, atr)
        cam = scenes.camera_rays(**cs.ATRIUM_CAM, width=1024, height=1024,
                                 order="morton", device=dev)
        prim = pt.trace_packets(tables[8], cam)
        nrm = geometric_normal(prim, cam.direction)
        gen = torch.Generator(device=dev).manual_seed(0)
        bounce = rt.Rays(origin=prim.position() + 1e-3 * nrm,
                         direction=cosine_sample(gen, nrm),
                         min_t=torch.full((cam.count,), 1e-3, device=dev),
                         max_t=torch.where(prim.hit,
                                           float(np.float32(3.4e38)), 0.0))
        order = torch.sort(ray_coherence_key(bounce.origin,
                                             bounce.direction),
                           stable=True).indices
        brows = rows_of(bounce.origin, bounce.direction, bounce.min_t,
                        bounce.max_t)[:, order].contiguous()
        for w in (8, 16):
            cases.append(("atrium", f"bounce{w}", "plain", tables[w],
                          brows, {}))
            cases.append(("atrium", f"bounce{w}_stats", "plain", tables[w],
                          brows, {"stats": True}))
        march = rt.Tracer(rt.build_from_soup(atr, config=rt.BuildConfig(
            leaf_size=16), device=dev), engine="march")
        cases.append(("atrium", "lbvh", "plain", march.packed, brows, {}))
        cm = march.grid.cells_march
        start, end = (torch.cuda.Event(enable_timing=True)
                      for _ in range(2))
        for name, rays in (("march", bounce), ("march_prim", cam)):
            for key, batch_of in (("", march_batch),
                                  ("_cellkey", cell_key_batch)):
                mg, mrows, _ = batch_of(march.grid, rays)
                cases.append(("atrium", name + key, "plain", cm, mrows,
                              {"grid": mg}))
                cases.append(("atrium", name + key + "_stats", "plain", cm,
                              mrows, {"grid": mg, "stats": True}))
                if rays is bounce:
                    marches.append((f"atrium/{name}{key}", cm, mrows, mg))
                # What grouping costs: the key, sort and gather.
                batch_of(march.grid, rays)
                start.record()
                for _ in range(5):
                    batch_of(march.grid, rays)
                end.record()
                torch.cuda.synchronize()
                emit({"grouping_ms": f"atrium/{name}{key}",
                      "ms": start.elapsed_time(end) / 5})
        if args.pairs:
            emit({"key_end_to_end": key_end_to_end(
                march, {"bounce": bounce, "primaries": cam}, args.pairs,
                10), "card": card})
        del tables, prim, nrm, bounce, order, march, cam

    # render: phase 9's atrium as four meshes; 9b's shadow rays and first
    # AO probe, and 9a's bounce 2 through the march
    if "render" in chosen:
        from rtk_tpu_torch.models import path

        cuts = np.cumsum((0,) + cs.ATRIUM_PARTS)
        rscene = rt.build_scene(
            [(atr[a:b].reshape(-1, 3),
              np.arange((b - a) * 3).reshape(-1, 3))
             for a, b in zip(cuts[:-1], cuts[1:])],
            rt.BuildConfig(leaf_size=16), device=dev)
        rtracer = rt.Tracer(rscene)
        rmarch = rt.Tracer(rscene, engine="march")
        mats = path.Materials.make(cs.ATRIUM_ALBEDO, cs.ATRIUM_EMISSION,
                                   device=dev)
        cam = scenes.camera_rays(**cs.ATRIUM_CAM, width=1024, height=1024,
                                 order="morton", device=dev)
        blog = cs.BounceLog(rtracer)
        path.render_direct(blog, cam, mats, **cs.ATRIUM_LIGHT)
        path.render_ao(blog, cam,
                       torch.Generator(device=dev).manual_seed(3),
                       samples=8, max_dist=3.0)
        for name, batch in (("shadow", blog.any_batches[0]),
                            ("ao", blog.any_batches[1])):
            r9, _ = pt._ray_rows(pt.front_steps(batch.device), batch, None)
            cases.append(("render", name, "plain", rtracer.packed, r9,
                          {"mode_any": 1}))
            cases.append(("render", name + "_stats", "plain",
                          rtracer.packed, r9,
                          {"mode_any": 1, "stats": True}))
        mlog = cs.BounceLog(rtracer, rmarch)
        path.render_path(mlog, cam, mats,
                         torch.Generator(device=dev).manual_seed(1),
                         bounces=4, background=(0.2, 0.3, 0.4))
        mg9, mrows9, _ = march_batch(rmarch.grid, mlog.batches[2])
        cm9 = rmarch.grid.cells_march
        cases.append(("render", "march_b2", "plain", cm9, mrows9,
                      {"grid": mg9}))
        cases.append(("render", "march_b2_stats", "plain", cm9, mrows9,
                      {"grid": mg9, "stats": True}))
        cases.append(("render", "march_b2_cellkey", "plain", cm9,
                      cell_key_batch(rmarch.grid, mlog.batches[2])[1],
                      {"grid": mg9}))
        marches.append(("render/march_b2", cm9, mrows9, mg9))
        del blog, mlog, cam, rscene, rtracer, rmarch
    del atr
    emit({"batches": {f"{b}/w{pk.branching}": {
        "rays": r.shape[1], "node_rows": pk.nodes.shape[0],
        "tri_rows": pk.tris.shape[0], "leaf_size": pk.leaf_size,
        "table_mb": (pk.nodes.numel() + pk.tris.numel()) * 4 / 1e6}
        for b, _, _, pk, r, _ in cases},
          "l2_bytes": torch.cuda.get_device_properties(0).L2_cache_size})
    # Each case's rows: the share of 32-ray warps whose shear axes differ.
    emit({"mixed_axis_share": {
        f"{b}/{c}": mixed_axis_share(r[3:6].T)
        for b, c, _, _, r, _ in cases if not c.endswith("stats")}})

    outs = {}
    stream = torch.cuda.current_stream().cuda_stream

    def launch(lib, pk, rws, ray_index=None, mode_any=0, qmask=None,
               defer_uv=0, stats=False, roots=None, grid=None):
        n = rws.shape[1]
        if n not in outs:
            outs[n] = (torch.empty(n, device=dev), torch.empty(n, device=dev),
                       torch.empty(n, device=dev),
                       torch.empty(n, dtype=torch.int32, device=dev),
                       torch.empty((5, n), dtype=torch.int32, device=dev))
        o = outs[n]
        tail = (*(x.data_ptr() for x in o[:4]),
                o[4].data_ptr() if stats else None, stream)
        common = (int(qmask is not None), int(qmask or 0))
        if grid is not None:
            occ = ((grid.occ.data_ptr(),) if takes_occ[id(lib)] else ())
            err = lib.rtk_packet_march(
                pk.nodes.data_ptr(), pk.tris.data_ptr(), rws.data_ptr(), n,
                pk.leaf_size, mode_any, 1, *common, *grid.dims, *grid.lo,
                *grid.cs, *grid.hi, *occ, *tail)
        else:
            err = lib.rtk_packet_trace(
                pk.nodes.data_ptr(), pk.tris.data_ptr(), rws.data_ptr(),
                None if roots is None else roots.data_ptr(),
                None if ray_index is None else ray_index.data_ptr(), n,
                pk.leaf_size, pk.branching, mode_any, 1, *common, defer_uv,
                *tail)
        if err:
            raise RuntimeError(f"launch failed: CUDA error {err}")
        return o

    # ---- every build equals the first, bit for bit ----
    want = {}
    for label, libs in builds:
        for batch, case, kind, pk, rws, kw in cases:
            o = launch(libs[kind], pk, rws, **kw)
            torch.cuda.synchronize()
            got = [x.view(torch.int32).clone() for x in o[:4]]
            if kw.get("stats"):
                got.append(o[4].clone())
            key = batch, case
            if key not in want:
                want[key] = got
                if kw.get("stats"):
                    c = o[4].double()
                    warp = warp_view(c)
                    s = c.sum(dim=1)
                    extra = {"box_per_internal": float(s[3] / s[1])}
                    if kw.get("mode_any"):
                        extra["idle_lane_share"] = idle_lane_share(c[0])
                    if kw.get("qmask") is not None:
                        extra["masked_row_share"] = float(
                            1 - s[4] / (s[2] * pk.leaf_size))
                    emit({"per_ray_mean": f"{batch}/{case}", **dict(zip(
                        COUNTS, c.mean(dim=1).tolist())),
                        "max": dict(zip(COUNTS, c.amax(dim=1).tolist())),
                        "warp_max_over_mean": dict(zip(COUNTS, (
                            warp.amax(dim=2).mean(dim=1)
                            / c.mean(dim=1)).tolist())), **extra})
            for g, w in zip(got, want[key]):
                if not torch.equal(g, w):
                    raise RuntimeError(f"{label}/{batch}/{case} differs from "
                                       f"{builds[0][0]}")
    del want
    emit({"bit_equal": [b for b, _ in builds],
          "cases": [f"{b}/{c}" for b, c, *_ in cases]})

    # ---- the march batches' cells, from the plain version's rounds ----
    for name, cm, mrows, mg in marches:
        t0 = time.perf_counter()
        counts, rounds = march_rounds(pt, cm, mrows, mg)
        want = launch(builds[0][1]["plain"], cm, mrows, grid=mg,
                      stats=True)[4]
        if not torch.equal(counts, want):
            raise RuntimeError(f"{name}: the rounds' counts differ from "
                               "the kernel's")
        emit({"march_cells": name, **march_cells(counts, rounds),
              "s": time.perf_counter() - t0})
        del counts, rounds
    del marches

    # ---- clocks under load ----
    for _ in range(12):
        launch(builds[0][1]["plain"], packed, rows)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip()
    torch.cuda.synchronize()
    emit({"under_load": smi, "card": card})

    # ---- times ----
    timed_cases = [c for c in cases if not c[1].endswith("stats")
                   or c[0] == "headline" and c[1] == "stats"]
    ms = {(b, bt, c): [] for b, _ in builds for bt, c, *_ in timed_cases}
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    for rnd in range(2 * args.rounds):
        for label, libs in (builds if rnd % 2 == 0 else builds[::-1]):
            for batch, case, kind, pk, rws, kw in timed_cases:
                launch(libs[kind], pk, rws, **kw)
                torch.cuda.synchronize()
                reps = args.reps * REPS_SCALE[batch]
                start.record()
                for _ in range(reps):
                    launch(libs[kind], pk, rws, **kw)
                end.record()
                torch.cuda.synchronize()
                ms[label, batch, case].append(start.elapsed_time(end) / reps)
    for label, _ in builds:
        rec = {"build": label, "card": card, "ms": {
            f"{bt}/{c}": {"min": min(v), "median": statistics.median(v),
                          "all": v}
            for (b, bt, c), v in ms.items() if b == label}}
        emit(rec, {"build": label, "median_ms": {
            k: round(v["median"], 4) for k, v in rec["ms"].items()}})


if __name__ == "__main__":
    main()

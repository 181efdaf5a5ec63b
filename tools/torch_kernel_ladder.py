"""Time builds of rtk_tpu_torch's traversal kernel against each other on one
CUDA card, with what the compiler made of each.

    python3 tools/torch_kernel_ladder.py [--source [LABEL=]PATH]... [--variant [LABEL:]NAME=FLAGS]...

Each --source is a copy of csrc/packet_trace.cu with the same C interface
(default: the package's own; e.g. `parent=` a checkout of another commit
beside `tree=` this one's); each --variant is a name and extra nvcc
flags (`base=`, `sort=-DK1_SORT`), built from every source, or from the
source LABEL only when given as `LABEL:NAME=FLAGS`, so a source that
switches its changes on preprocessor macros gives a ladder of builds.  Every (source, variant)
is built twice, plain and with the odd-triangle filter predicate, and:

  * ptxas -v's registers, frame and spills per instantiation are printed;
  * `cuobjdump -sass` of each build is written to --out (default
    rtk_tpu_torch/build/ladder/), and per kernel the instruction count, the counts
    of LDL/STL/LDG and the loops (backward branches with their lengths)
    are printed;
  * the kernel alone is timed with CUDA events on three batches:
    - "headline": the main path's rows at --width^2 (default 8192):
      blob(6), LBVH leaf 4, morton camera rays in coherence-key order.
      Modes: closest, any, mask, defer_uv, stats, and the filter build
      with ray_index;
    - "grid8b": chip_smoke.py phase 8b's rows: deforming_grid(n=1024)
      (2,097,152 triangles) on LBVH leaf-8 tables refit to t = 0.2, 2048^2
      morton camera rays unsorted; defer_uv (the rows phase 8b times) and
      closest;
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
      8- and 16-wide tables, and through the grid march on the atrium's
      LBVH (leaf 16) with march_batch's rows;
    The builds run in turn, forwards then backwards, --rounds times; the
    minimum and median of the rounds are reported;
  * every output of every build (t, u, v, slot, counts) must equal the
    first build's bit for bit; the first build's per-ray counts are
    printed with their divergence (per 32-ray warp, the mean of the
    warp's largest count over the mean count);
  * clocks.sm and power.draw are sampled by nvidia-smi while launches of
    the first build are queued, and the per-ray counts of the stats
    variant are printed, so the time the instruction stream needs if it
    never stalls (instructions a ray over 132 SMs x 4 schedulers x the
    clock) can be estimated from the SASS counts.

One JSON object per line; needs a CUDA card and nvcc; imports no jax.
"""
import argparse
import ctypes
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
REPS_SCALE = {"headline": 1, "grid8b": 12, "roots": 60, "w16": 1,
              "atrium": 12}


def sass_summary(text):
    """Per kernel of a cuobjdump -sass listing: instructions, local and
    global memory instructions, the opcode histogram's head, and every
    loop as (first address, last address, instructions)."""
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
    short = {}
    for k, v in out.items():
        m = re.search(r"ILi(\d+)ELb([01])E", k)
        short[f"w{m.group(1)}" + ("_march" if m.group(2) == "1" else "")
              if m else k] = v
    return short


def ptxas_summary(log):
    out, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function .*?ILi(\d+)ELb([01])E", ln)
        if m:
            name = f"w{m.group(1)}" + ("_march" if m.group(2) == "1" else "")
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
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device; none found")

    import rtk_tpu_torch as rt
    from rtk_tpu_torch.ops import packet_trace as pt
    from rtk_tpu_torch.ops.morton import ray_coherence_key
    from rtk_tpu_torch.testing import scenes
    from rtk_tpu_torch.utils.build import BUILD_DIR, build_shared

    dev = torch.device("cuda")
    out_dir = pathlib.Path(args.out or BUILD_DIR / "ladder")
    out_dir.mkdir(parents=True, exist_ok=True)
    log = open(out_dir / "ladder.jsonl", "w")

    def emit(rec):
        """One JSON line to the standard output and to --out/ladder.jsonl
        (a long run's first lines outlive a truncated console)."""
        line = json.dumps(rec)
        print(line, flush=True)
        log.write(line + "\n")
        log.flush()

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip()
    sources = [(s.split("=", 1)[0] if "=" in s else f"source{i}",
                pathlib.Path(s.split("=", 1)[-1]).resolve())
               for i, s in enumerate(args.source)] or [("", pt.KERNEL_SRC)]
    variants = [v.split("=", 1) for v in args.variant] or [["tree", ""]]
    variants = [(n.split(":", 1) if ":" in n else [None, n]) + [f]
                for n, f in variants]

    # ---- builds: every (source, variant), plain and filter, in parallel ----
    flt = rt.jit_filter(ODD_TRI)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    header = BUILD_DIR / f"ladder-filter-{flt.key}.h"
    header.write_text(flt.source)
    cuobjdump = pathlib.Path(pt._nvcc()).with_name("cuobjdump")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    jobs = []
    for si, (src_label, src) in enumerate(sources):
        for only, name, flags in variants:
            if only is not None and only != src_label:
                continue
            label = name if len(sources) == 1 else f"{src_label}:{name}"
            for kind, extra, deps in (
                    ("plain", [], []),
                    ("filter", ["-DRTK_FILTER", f"-I{pt.CSRC}", "-include",
                                str(header)], [pt.FILTER_OPS, header])):
                jobs.append((label, src, flags, kind,
                             f"ladder{si}_{name}_{kind}",
                             [pt._nvcc(), *pt.NVCC_FLAGS, *flags.split(),
                              *extra], deps))

    def run_build(job):
        _, src, _, _, lib_name, command, deps = job
        t0 = time.perf_counter()
        so, build_log = build_shared(lib_name, [src], command, deps=deps)
        return so, build_log, time.perf_counter() - t0

    with ThreadPoolExecutor(max_workers=8) as pool:
        built = list(pool.map(run_build, jobs))
    builds, recs = [], {}
    for (label, src, flags, kind, *_), (so, build_log, secs) in zip(jobs,
                                                                    built):
        sass = subprocess.run([str(cuobjdump), "-sass", str(so)],
                              check=True, capture_output=True,
                              text=True).stdout
        tag = label.replace("/", "_").replace(":", "_")
        (out_dir / f"{tag}.{kind}.sass").write_text(sass)
        lib = ctypes.CDLL(str(so))
        lib.rtk_packet_trace.restype = i32
        lib.rtk_packet_trace.argtypes = [ptr] * 5 + [i32] * 8 + [ptr] * 6
        if kind == "plain":
            lib.rtk_packet_march.restype = i32
            lib.rtk_packet_march.argtypes = ([ptr] * 3 + [i32] * 9
                                             + [ctypes.c_float] * 9
                                             + [ptr] * 6)
        rec = recs.setdefault(label, {"build": label, "source": str(src),
                                      "flags": flags})
        rec[kind] = {"s": round(secs, 2), "ptxas": ptxas_summary(build_log),
                     "sass": sass_summary(sass)}
        if kind == "plain":
            builds.append((label, {}))
        dict(builds)[label][kind] = lib
    for rec in recs.values():
        emit(rec)

    # ---- the batches: tables, rows and cases ----
    import chip_smoke as cs
    from rtk_tpu_torch import instancing
    from rtk_tpu_torch.scene import refit
    from rtk_tpu_torch.trace.packed import repack_bounds

    def rows_of(o, d, mint, maxt):
        return torch.cat([o.T, d.T, mint[None], maxt[None]]).contiguous()

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

    # grid8b
    cfg = rt.BuildConfig(branching=8, leaf_size=8, wide_nodes=False)
    g0 = scenes.deforming_grid(0.0, n=1024)
    scene8 = rt.build_from_soup(g0, config=cfg, device=dev)
    p8 = rt.Tracer(scene8, tri_mask=np.where(
        np.arange(g0.shape[0]) % 2 == 1, 1, 2).astype(np.uint32)).packed
    p8 = repack_bounds(p8, refit(scene8, torch.as_tensor(
        scenes.deforming_grid(0.2, n=1024), device=dev)))
    del scene8, g0
    cam8 = scenes.camera_rays(**cs.GRID_CAM, width=2048, height=2048,
                              order="morton", device=dev, on_device=True)
    rows8 = rows_of(cam8.origin, cam8.direction, cam8.min_t, cam8.max_t)
    del cam8
    for m in ("defer_uv", "closest", "stats"):
        cases.append(("grid8b", m, "plain", p8, rows8, MODES[m]))

    # roots: config 5's round 0
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
                                       cam5.origin[s_], cam5.direction[s_])
        r5 = rows_of(o, d, cam5.min_t[s_], cam5.max_t[s_])
        roots = ps.packed_roots[iscene.instance_blas[i_]].contiguous()
        cases.append(("roots", name, "plain", ps.packed, r5,
                      {"roots": roots}))
        cases.append(("roots", name + "_stats", "plain", ps.packed, r5,
                      {"roots": roots, "stats": True}))
    del cand, sel, inst, cam5, iscene

    # w16: phase 7's 16-wide headline
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
    from rtk_tpu_torch.models.path import cosine_sample, geometric_normal
    from rtk_tpu_torch.testing.grid import march_batch

    atr = scenes.atrium()
    tables, _ = cs.sah_widths(rt, dev, atr)
    cam = scenes.camera_rays(**cs.ATRIUM_CAM, width=1024, height=1024,
                             order="morton", device=dev)
    prim = pt.trace_packets(tables[8], cam)
    nrm = geometric_normal(prim, cam.direction)
    gen = torch.Generator(device=dev).manual_seed(0)
    bounce = rt.Rays(origin=prim.position() + 1e-3 * nrm,
                     direction=cosine_sample(gen, nrm),
                     min_t=torch.full((cam.count,), 1e-3, device=dev),
                     max_t=torch.where(prim.hit, float(np.float32(3.4e38)),
                                       0.0))
    order = torch.sort(ray_coherence_key(bounce.origin, bounce.direction),
                       stable=True).indices
    brows = rows_of(bounce.origin, bounce.direction, bounce.min_t,
                    bounce.max_t)[:, order].contiguous()
    for w in (8, 16):
        cases.append(("atrium", f"bounce{w}", "plain", tables[w], brows, {}))
        cases.append(("atrium", f"bounce{w}_stats", "plain", tables[w],
                      brows, {"stats": True}))
    march = rt.Tracer(rt.build_from_soup(atr, config=rt.BuildConfig(
        leaf_size=16), device=dev), engine="march")
    mg, mrows, _ = march_batch(march.grid, bounce)
    cm = march.grid.cells_march
    cases.append(("atrium", "march", "plain", cm, mrows, {"grid": mg}))
    cases.append(("atrium", "march_stats", "plain", cm, mrows,
                  {"grid": mg, "stats": True}))
    del tables, prim, nrm, bounce, order, march, cam
    emit({"batches": {b: {"rays": r.shape[1], "node_rows": pk.nodes.shape[0],
                          "tri_rows": pk.tris.shape[0],
                          "table_mb": (pk.nodes.numel() + pk.tris.numel())
                          * 4 / 1e6}
                      for b, _, _, pk, r, _ in cases},
          "l2_bytes": torch.cuda.get_device_properties(0).L2_cache_size})

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
            err = lib.rtk_packet_march(
                pk.nodes.data_ptr(), pk.tris.data_ptr(), rws.data_ptr(), n,
                pk.leaf_size, mode_any, 1, *common, *grid.dims, *grid.lo,
                *grid.cs, *grid.hi, *tail)
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
                    warp = c[:, :c.shape[1] // 32 * 32].reshape(5, -1, 32)
                    emit({"per_ray_mean": f"{batch}/{case}", **dict(zip(
                        COUNTS, c.mean(dim=1).tolist())),
                        "max": dict(zip(COUNTS, c.amax(dim=1).tolist())),
                        "warp_max_over_mean": dict(zip(COUNTS, (
                            warp.amax(dim=2).mean(dim=1)
                            / c.mean(dim=1)).tolist()))})
            for g, w in zip(got, want[key]):
                if not torch.equal(g, w):
                    raise RuntimeError(f"{label}/{batch}/{case} differs from "
                                       f"{builds[0][0]}")
    del want
    emit({"bit_equal": [b for b, _ in builds],
          "cases": [f"{b}/{c}" for b, c, *_ in cases]})

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
        emit({"build": label, "card": card, "ms": {
            f"{bt}/{c}": {"min": min(v), "median": statistics.median(v),
                          "all": v}
            for (b, bt, c), v in ms.items() if b == label}})


if __name__ == "__main__":
    main()

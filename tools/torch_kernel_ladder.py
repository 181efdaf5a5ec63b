"""Time builds of rtk_tpu_torch's traversal kernel against each other on one
CUDA card, with what the compiler made of each.

    python3 tools/torch_kernel_ladder.py [--source [LABEL=]PATH]... [--variant NAME=FLAGS]...

Each --source is a copy of csrc/packet_trace.cu with the same C interface
(default: the package's own; e.g. `parent=` a checkout of another commit
beside `tree=` this one's); each --variant is a name and extra nvcc
flags (`base=`, `sort=-DK1_SORT`), so a source that switches its changes
on preprocessor macros gives a ladder of builds.  Every (source, variant)
is built twice, plain and with the odd-triangle filter predicate, and:

  * ptxas -v's registers, frame and spills per instantiation are printed;
  * `cuobjdump -sass` of each build is written to --out (default
    rtk_tpu_torch/build/ladder/), and per kernel the instruction count, the counts
    of LDL/STL/LDG and the loops (backward branches with their lengths)
    are printed;
  * the kernel alone is timed with CUDA events at --width^2 (default
    8192) on the main path's rows: blob(6), LBVH leaf 4, morton camera
    rays in coherence-key order.  Modes: closest, any, mask, defer_uv,
    stats, and the filter build with ray_index.  The builds run in turn,
    forwards then backwards, --rounds times; the minimum and median of the
    rounds are reported;
  * every output of every build (t, u, v, slot, counts) must equal the
    first build's bit for bit;
  * clocks.sm and power.draw are sampled by nvidia-smi while launches of
    the first build are queued, and the per-ray counts of the stats
    variant are printed, so the time the instruction stream needs if it
    never stalls (instructions a ray over 132 SMs x 4 schedulers x the
    clock) can be estimated from the SASS counts.

One JSON object per line; needs a CUDA card and nvcc; imports no jax.
"""
import argparse
import ctypes
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

    # ---- builds ----
    flt = rt.jit_filter(ODD_TRI)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    header = BUILD_DIR / f"ladder-filter-{flt.key}.h"
    header.write_text(flt.source)
    cuobjdump = pathlib.Path(pt._nvcc()).with_name("cuobjdump")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    builds = []
    for si, (src_label, src) in enumerate(sources):
        for name, flags in variants:
            label = name if len(sources) == 1 else f"{src_label}:{name}"
            libs = {}
            rec = {"build": label, "source": str(src), "flags": flags}
            for kind, extra, deps in (
                    ("plain", [], []),
                    ("filter", ["-DRTK_FILTER", f"-I{pt.CSRC}", "-include",
                                str(header)], [pt.FILTER_OPS, header])):
                t0 = time.perf_counter()
                so, build_log = build_shared(
                    f"ladder{si}_{name}_{kind}", [src],
                    [pt._nvcc(), *pt.NVCC_FLAGS, *flags.split(), *extra],
                    deps=deps)
                sass = subprocess.run([str(cuobjdump), "-sass", str(so)],
                                      check=True, capture_output=True,
                                      text=True).stdout
                tag = label.replace("/", "_").replace(":", "_")
                (out_dir / f"{tag}.{kind}.sass").write_text(sass)
                lib = ctypes.CDLL(str(so))
                lib.rtk_packet_trace.restype = i32
                lib.rtk_packet_trace.argtypes = ([ptr] * 5 + [i32] * 8
                                                 + [ptr] * 6)
                libs[kind] = lib
                rec[kind] = {"s": round(time.perf_counter() - t0, 2),
                             "ptxas": ptxas_summary(build_log),
                             "sass": sass_summary(sass)}
            emit(rec)
            builds.append((label, libs))

    # ---- the main path's tables and rows ----
    v6, f6 = scenes.blob(6)[1:]
    mask = np.where(np.arange(f6.shape[0]) % 2 == 1, 1, 2).astype(np.uint32)
    packed = rt.Tracer(rt.build_scene((v6, f6), device=dev),
                       tri_mask=mask).packed
    rays = scenes.camera_rays(**CAM, width=args.width, height=args.width,
                              order="morton", device=dev, on_device=True)
    order = torch.sort(ray_coherence_key(rays.origin, rays.direction),
                       stable=True).indices
    rows = torch.cat([rays.origin.T, rays.direction.T, rays.min_t[None],
                      rays.max_t[None]])[:, order].contiguous()
    ridx = order.to(torch.int32)
    n = rows.shape[1]
    del rays, order
    outs = (torch.empty(n, device=dev), torch.empty(n, device=dev),
            torch.empty(n, device=dev),
            torch.empty(n, dtype=torch.int32, device=dev))
    counts = torch.empty((5, n), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream().cuda_stream

    def launch(lib, ray_index=None, mode_any=0, qmask=None, defer_uv=0,
               stats=False):
        err = lib.rtk_packet_trace(
            packed.nodes.data_ptr(), packed.tris.data_ptr(), rows.data_ptr(),
            None, None if ray_index is None else ray_index.data_ptr(), n,
            packed.leaf_size, 8, mode_any, 1, int(qmask is not None),
            int(qmask or 0), defer_uv, *(o.data_ptr() for o in outs),
            counts.data_ptr() if stats else None, stream)
        if err:
            raise RuntimeError(f"launch failed: CUDA error {err}")

    cases = [(m, "plain", kw) for m, kw in MODES.items()]
    cases.append(("filter", "filter", {"ray_index": ridx}))
    cases.append(("filter_stats", "filter", {"ray_index": ridx,
                                             "stats": True}))

    # ---- every build equals the first, bit for bit ----
    want = {}
    for label, libs in builds:
        for case, kind, kw in cases:
            launch(libs[kind], **kw)
            torch.cuda.synchronize()
            got = [o.view(torch.int32).clone() for o in outs]
            if kw.get("stats"):
                got.append(counts.clone())
            if case not in want:
                want[case] = got
                if kw.get("stats"):
                    emit({"per_ray_mean": case, **dict(zip(
                        ("steps", "internal_pops", "leaf_pops", "box_tests",
                         "tri_tests"),
                        counts.double().mean(dim=1).tolist()))})
            for g, w in zip(got, want[case]):
                if not torch.equal(g, w):
                    raise RuntimeError(f"{label}/{case} differs from "
                                       f"{builds[0][0]}")
    del want
    emit({"bit_equal": [b for b, _ in builds],
          "cases": [c for c, _, _ in cases]})

    # ---- clocks under load ----
    for _ in range(12):
        launch(builds[0][1]["plain"])
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip()
    torch.cuda.synchronize()
    emit({"under_load": smi, "card": card})

    # ---- times ----
    ms = {(b, c): [] for b, _ in builds for c, _, _ in cases if
          c != "filter_stats"}
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    for rnd in range(2 * args.rounds):
        for label, libs in (builds if rnd % 2 == 0 else builds[::-1]):
            for case, kind, kw in cases:
                if case == "filter_stats":
                    continue
                launch(libs[kind], **kw)
                torch.cuda.synchronize()
                start.record()
                for _ in range(args.reps):
                    launch(libs[kind], **kw)
                end.record()
                torch.cuda.synchronize()
                ms[label, case].append(start.elapsed_time(end) / args.reps)
    for label, _ in builds:
        emit({"build": label, "rays": n, "card": card, "ms": {
            c: {"min": min(v), "median": statistics.median(v), "all": v}
            for (b, c), v in ms.items() if b == label}})


if __name__ == "__main__":
    main()

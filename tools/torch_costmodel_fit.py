"""Fit rtk_tpu_torch.utils.costmodel's constants on the card from a sweep
of the main path.

    python3 tools/torch_costmodel_fit.py [--out costmodel_fit.json]

Run it from the repository's root on a machine with one CUDA card (the
H100 the constants are for); it needs only the committed files and takes
about three minutes, the kernel's nvcc build included.  Copy the printed
"fit:" values into rtk_tpu_torch/utils/costmodel.py.

Each of RUNS processes of its own builds blob(6) (81,920 triangles,
build_scene: LBVH leaf 4, as chip_smoke.py phase 3) and traces Morton
primaries of the headline camera at 64^2, 128^2, ..., 8192^2 through
Tracer.closest.  Per size (measure()): the host wall ms of one
synchronised call and the host's ms to issue it (medians of CALLS, after
a warm call), the card's busy ms in one call (torch.profiler: the union of
its device events, the largest of three windows, each opened with
spins on the card that the profiler's losses fall on), the steady ms of
back-to-back calls (measure_trace: CUDA events), the kernel alone on the
rows the call launches it on (CUDA events) and steps_per_block (the stats
variant on unsorted rays).  At 1024^2 and 8192^2 it also times
trace_packets(pkt=128) against trace_packets(pkt=2048) in PAIRS
alternating pairs (pkt selects nothing but the layout of packet_roots,
which these calls do not pass).  The host's speed drifts within a process
and differs between processes by a third or more on one machine, so each
size takes the median of many calls, and the fit reads each field's
median over the runs.

The fit: a, b, c and DISPATCH_MS together, by least squares in relative
error of the wall ms over the sizes of 1024^2 and above (the card full: 132
SMs x 10 blocks x 128 threads is about 169k rays), at P = 8 with PKT = 128
and 512 (fit()).  DISPATCH_MS is the formula's fixed cost of a call: its
intercept over those sizes.  It is not the host's share alone: on the H100,
with the coherence key and the unsort on the card, a sorted call leaves the
card idle for 0.16-0.42 ms (the wall less the card's busy ms at 128^2,
host_share_128 in the record), while the card's own cost of a call that does
not grow with its rays (the traversal's depth-bound latency, about 0.2 ms
even at 64^2, and the sort's passes) is as large.  At one P the per-packet
term A * P and the per-step term C enter as one sum, which the fit reports
as C, with A = 0; no term is negative (non-negative least squares).  It
prints the fitted constants and each size's relative error under them and
under the module's constants, per run and for the medians, the card's name
and power limit, and writes the whole record as JSON to --out.  Needs a CUDA
device; imports no jax.
"""
import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
from scipy.optimize import nnls

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAM = dict(eye=(0, 0, 3.0), look_at=(0, 0, 0), up=(0, 1, 0), fov_deg=45)
SIZES = (64, 128, 256, 512, 1024, 2048, 4096, 8192)
RUNS = 5  # processes, each a sweep
CALLS = 31  # synchronised calls a size
PAIRS = 10  # alternating pairs of the pkt check
FIT_MIN = 1024  # the fit's smallest side: the card is full from here
FIT_P = 8
FIT_PKTS = (128, 512)
PKT_SIDES = (1024, 8192)
PKT_WIDTHS = (128, 2048)
FIELDS = ("wall_ms", "enqueue_ms", "device_ms", "steady_ms", "kernel_ms",
          "steps_per_block")
PAD_SPINS = 256  # short spins that open and close each profiler window
SPIN_KERNEL = "spin_kernel"  # torch.cuda._sleep's kernel (ATen's Sleep.cu)


def cuda_ms(fn, reps):
    """ms per call of fn over `reps` back-to-back calls, CUDA events,
    after a warm call."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def busy_ms(prof):
    """The card's busy ms in a profiled window: the union of its device
    events' intervals, the spins that open the window left out."""
    import torch

    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and SPIN_KERNEL not in e.name)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            busy += 0.0 if cur_e is None else cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return (busy + (0.0 if cur_e is None else cur_e - cur_s)) / 1e3


def device_ms(run, windows=3):
    """The card's busy ms in one call of run(): the largest over
    `windows` torch.profiler windows of one synchronised call each (the
    profiler can drop a window's device events, never add some).  Each
    window opens and closes with PAD_SPINS short spins on the card
    (torch.cuda._sleep), finished before run() starts and started after
    it ends: late in a long process the profiler loses the first device
    records of a window, up to all of a short call's, and at times its
    last ones, and the spins take that loss.  A window is kept only if
    the profiler recorded a spin before the call's records and one after
    them (chip_smoke.py's clean_window); while none is, up to `windows`
    more are taken, and then it raises."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    busy = []
    for i in range(2 * windows):
        if i >= windows and busy:
            break
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
        if calls:
            lead = sum(t < min(r.start for r in calls) for t in spins)
            tail = sum(t >= max(r.end for r in calls) for t in spins)
            if lead and tail:
                busy.append(busy_ms(prof))
    if not busy:
        raise RuntimeError(f"torch.profiler's losses reached the call in "
                           f"each of {2 * windows} windows")
    return max(busy)


def measure(tracer, rays, calls=CALLS):
    """One batch's record: wall_ms (host clock around one call and a
    synchronize, the median of `calls`), enqueue_ms (the host's time until
    the call returns, the median of the same calls), device_ms (the card's
    busy ms in one call), steady_ms (measure_trace over `calls` back-to-
    back calls), kernel_ms (the kernel alone on the rows Tracer.closest
    launches it on) and steps_per_block."""
    import torch

    from rtk_tpu_torch.ops import packet_trace as pt
    from rtk_tpu_torch.utils.stats import measure_trace

    sync = torch.cuda.synchronize
    run = lambda: tracer.closest(rays)  # noqa: E731
    run()
    walls, issued = [], []
    for _ in range(calls):
        sync()
        t0 = time.perf_counter()
        run()
        issued.append((time.perf_counter() - t0) * 1e3)
        sync()
        walls.append((time.perf_counter() - t0) * 1e3)
    st = measure_trace(tracer, rays, iters=calls, with_steps=True)
    packed = tracer.packed
    rows, _ = pt._ray_rows(pt.front_steps(rays.device), rays, None)
    kernel_ms = cuda_ms(lambda: pt.packet_trace_kernel(
        packed.nodes, packed.tris, rows, leaf_size=packed.leaf_size,
        stack_size=packed.stack_size), calls)
    return {"rays": rays.count, "wall_ms": float(np.median(walls)),
            "wall_ms_min": min(walls), "wall_ms_max": max(walls),
            "enqueue_ms": float(np.median(issued)),
            "device_ms": device_ms(run), "steady_ms": st.seconds * 1e3,
            "kernel_ms": kernel_ms, "steps_per_block": st.steps_per_block}


def fixed_ms(sweep):
    """DISPATCH_MS of a sweep {side: measure() record}: fit()'s fixed cost
    of a call over its sides of FIT_MIN and above."""
    return fit([r for s, r in sweep.items() if s >= FIT_MIN])[3]


def host_share_ms(sweep, sort_min):
    """The part of a call the card's work does not cover: wall_ms less
    device_ms at the smallest side of at least sort_min rays (the
    smallest batch that takes the sorted front end)."""
    r = sweep[min(s for s in sweep if s * s >= sort_min)]
    return r["wall_ms"] - r["device_ms"]


def fit(rows, p=FIT_P, pkts=FIT_PKTS):
    """(a_us, b_us, c_us, dispatch_ms) from records of measure() (with
    "rays", "wall_ms", "steps_per_block"): least squares of
    blocks * steps_per_block * (a p + b p pkt + c) / 1e3 + dispatch_ms
    against wall_ms, each row weighted by 1 / wall_ms, one row per record
    and pkt, no term below 0 (non-negative least squares).  a p + c is one
    term at one p: returned as c, with a = 0."""
    cols = []
    for r in rows:
        for pkt in pkts:
            steps = max(1, r["rays"] // (p * pkt)) * r["steps_per_block"]
            w = 1.0 / r["wall_ms"]
            cols.append([steps * p * pkt / 1e3 * w, steps / 1e3 * w, w])
    b, c, dispatch = nnls(np.asarray(cols), np.ones(len(cols)))[0]
    return 0.0, float(b), float(c), float(dispatch)


def predict_ms(model, dispatch_ms, n_rays, steps_per_block):
    """model.trace_ms at auto_pkt's width, with dispatch_ms in place of
    the module's DISPATCH_MS."""
    from rtk_tpu_torch.utils import costmodel

    return (model.trace_ms(n_rays, costmodel.auto_pkt(n_rays),
                           steps_per_block)
            - costmodel.DISPATCH_MS + dispatch_ms)


def quartiles(xs):
    q1, q2, q3 = np.percentile(xs, [25, 50, 75])
    return {"median": float(q2), "q1": float(q1), "q3": float(q3)}


def pkt_check(packed, rays, pairs=PAIRS, reps=3):
    """trace_packets at the two PKT_WIDTHS in `pairs` pairs, the order
    alternating -> per width its ms quartiles; same_within_noise: the
    medians differ by no more than the larger interquartile range."""
    from rtk_tpu_torch.ops.packet_trace import trace_packets

    ms = {w: [] for w in PKT_WIDTHS}
    for i in range(pairs):
        for w in (PKT_WIDTHS if i % 2 == 0 else PKT_WIDTHS[::-1]):
            ms[w].append(cuda_ms(lambda: trace_packets(packed, rays, pkt=w),
                                 reps))
    q = {w: quartiles(v) for w, v in ms.items()}
    a, b = (q[w] for w in PKT_WIDTHS)
    noise = max(a["q3"] - a["q1"], b["q3"] - b["q1"])
    return {**{f"pkt{w}": q[w] for w in PKT_WIDTHS},
            "median_diff_ms": b["median"] - a["median"], "noise_ms": noise,
            "same_within_noise": abs(b["median"] - a["median"]) <= noise}


def sweep_here():
    """One run's sweep, in this process -> {side: measure() record}."""
    import torch

    import rtk_tpu_torch as rt
    from rtk_tpu_torch.testing import scenes

    if not torch.cuda.is_available():
        raise SystemExit("torch_costmodel_fit.py needs a CUDA device")
    dev = torch.device("cuda")
    v6, f6 = scenes.blob(6)[1:]
    tracer = rt.Tracer(rt.build_scene((v6, f6), device=dev))
    sweep = {}
    for side in SIZES:
        rays = scenes.camera_rays(**CAM, width=side, height=side,
                                  order="morton", device=dev, on_device=True)
        sweep[side] = measure(tracer, rays)
        if side in PKT_SIDES:
            sweep[side]["pkt_check"] = pkt_check(tracer.packed, rays)
        del rays
    return sweep


def errors(sweep, model, dispatch_ms):
    """{side: relative error of predict_ms against the wall}."""
    return {s: (predict_ms(model, dispatch_ms, r["rays"],
                           r["steps_per_block"]) - r["wall_ms"])
            / r["wall_ms"] for s, r in sweep.items()}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    sys.path.insert(0, REPO)
    if args.child:
        print(json.dumps(sweep_here()))
        return 0
    from rtk_tpu_torch.ops.packet_trace import SORT_RAYS_MIN
    from rtk_tpu_torch.utils import costmodel

    runs = []
    for i in range(RUNS):
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child"],
            cwd=REPO, capture_output=True, text=True)
        if proc.returncode:
            raise SystemExit(f"run {i} failed:\n{proc.stderr[-4000:]}")
        runs.append({int(s): r for s, r in json.loads(
            proc.stdout.strip().splitlines()[-1]).items()})
    med = {s: {"rays": runs[0][s]["rays"],
               **{f: float(np.median([r[s][f] for r in runs]))
                  for f in FIELDS}} for s in runs[0]}
    a, b, c, dispatch_ms = fit([r for s, r in med.items() if s >= FIT_MIN])
    fitted = costmodel.StepModel(a_us=a, b_us=b, c_us=c)
    module = costmodel.StepModel()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip()
    rec = {"card": card,
           "fit": {"A_US": a, "B_US": b, "C_US": c,
                   "DISPATCH_MS": dispatch_ms,
                   "host_share_128": host_share_ms(med, SORT_RAYS_MIN),
                   "steps_per_block_1024": med.get(1024, {}).get(
                       "steps_per_block"),
                   "fit_sides": [s for s in med if s >= FIT_MIN]},
           "module": {"A_US": module.a_us, "B_US": module.b_us,
                      "C_US": module.c_us,
                      "DISPATCH_MS": costmodel.DISPATCH_MS},
           "median": med, "runs": runs, "errors": {}}
    for name, sweep in [("median", med)] + [(f"run{i}", r)
                                            for i, r in enumerate(runs)]:
        rec["errors"][name] = {
            "fit": errors(sweep, fitted, dispatch_ms),
            "module": errors(sweep, module, costmodel.DISPATCH_MS),
            "run_fixed_ms": fixed_ms(sweep),
            "run_host_share_128": host_share_ms(sweep, SORT_RAYS_MIN)}
    print("side rays | median of the runs: wall_ms enqueue_ms device_ms "
          "steps/block | relative error, fit / module, median then per run")
    for s, r in med.items():
        errs = " ".join(f"{e['fit'][s]:+.3f}/{e['module'][s]:+.3f}"
                        for e in rec["errors"].values())
        print(f"{s}^2 {r['rays']} | {r['wall_ms']:.4f} {r['enqueue_ms']:.4f} "
              f"{r['device_ms']:.4f} {r['steps_per_block']:.3f} | {errs}")
    print("fixed ms, host share at 128^2 ms:",
          [(round(e["run_fixed_ms"], 4), round(e["run_host_share_128"], 4))
           for e in rec["errors"].values()])
    print("pkt 128 vs 2048:", json.dumps(
        {f"run{i}/{s}": {k: r[s]["pkt_check"][k] for k in (
            "median_diff_ms", "noise_ms", "same_within_noise")}
         for i, r in enumerate(runs) for s in PKT_SIDES if s in r}))
    print("fit:", json.dumps(rec["fit"]))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rec, f, indent=1)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())

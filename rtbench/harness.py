"""One run of one benchmark cell, driven by BENCHMARK.json.

A cell names a configuration (its file under rtbench/configs: the scene
generator, the tree the program builds, the query) and a traffic mix (its
file under rtbench/traffic: the kind of rays and its parameters, what is
checked and the limits).  Each piece of code is found by a name in the
data: the scene generator rtbench/scenes/<generator>.py, the traffic kind
rtbench/traffic/kinds/<kind>.py, the query kind rtbench/queries/<kind>.py
(the timed call and its check) and each per-layer metric's reader
rtbench/metrics/<name>.py.  `run_cell`:

  1. set-up: builds the scene with the program (through the query kind's
     `Program`), makes the batches from the seed on the device and warms
     every batch up twice (the first call builds the kernel library when
     the checkout has none);
  2. the window: one caller, closed loop, one batch at a time in turn;
     each call is the query kind's timed call and ends with a
     synchronize.  The records of `check.calls` calls, drawn from the
     seed as the calls come (reservoir sampling), are kept;
  3. with --trace 1: padded profiler windows over further calls, and the
     per-layer metrics, each read by its own file;
  4. the check: the program's state freed, the query kind's `check` holds
     the kept records to the plain reference, and its numbers to the
     traffic file's limits.

Of rtbench's files only the query kinds import the program; the metric
readers know the traversal kernel by its name (devtrace.py).
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from rtbench import devtrace, workcount
from rtbench.loader import load_module
from rtbench.traffic import generate

BENCH = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "rtk_tpu")
# Streams of a seed (generate.rng): the calls kept, the work count's
# sample (a query kind draws the rays it checks from streams 100-199).
KEEP, WORK = 2, 200
WORK_RAYS = 8192  # rays the work count walks, over all batches
TRACE_CALL_S = 0.1  # device time a profiled window should hold
TRACE_CALLS = (2, 128)  # calls a profiled window holds, at least and most


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one the run must not load."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def load_cell(root: Path, name: str) -> dict:
    """BENCHMARK.json's cell `name` with its configuration, traffic and
    the metrics it reports."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    w = work[name]
    cfg = {c["name"]: c for c in bench["configs"]}[w["config"]]

    def mine(m):
        return name in m.get("workloads", [name])

    return dict(
        workload=w,
        config=json.loads((root / cfg["file"]).read_text()),
        traffic=json.loads(
            (root / "rtbench" / "traffic" / f"{w['traffic']}.json")
            .read_text()),
        end_to_end=[m for m in bench["end_to_end"] if mine(m)],
        per_layer=[m for m in bench["per_layer"] if mine(m)],
        root=root)


def scene_of(cell) -> tuple:
    """The configuration's mesh from its generator -> (positions,
    indices), held to the triangles and meshes the configuration
    states."""
    cfg = cell["config"]
    sc = cfg["scene"]
    gen = load_module(cell["root"] / "rtbench" / "scenes" /
                      f"{sc['generator']}.py")
    positions, indices = gen.make(**sc.get("args", {}))
    stated = {"triangles": len(indices), "meshes": 1}
    for k, v in stated.items():
        if k in cfg and cfg[k] != v:
            raise ValueError(f"configuration {cfg.get('name')!r} states "
                             f"{k} {cfg[k]}, its generator gives {v}")
    return positions, indices


def query_of(cell):
    """The configuration's query kind: rtbench/queries/<kind>.py."""
    kind = cell["config"]["query"]["kind"]
    path = cell["root"] / "rtbench" / "queries" / f"{kind}.py"
    if not path.is_file():
        raise ValueError(f"unknown query kind {kind!r}: no {path.name} under "
                         f"rtbench/queries")
    return load_module(path)


def smi() -> str:
    """The card's name, clocks and power limit, as nvidia-smi reads them."""
    q = "name,clocks.sm,clocks.max.sm,clocks.mem,power.limit,power.draw"
    try:
        p = subprocess.run(["nvidia-smi", f"--query-gpu={q}",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=20)
        return p.stdout.strip() or p.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e})"


@dataclasses.dataclass
class Readings:
    """What the per-layer readers read: the window's host times, the
    profiled windows and the roofline's bound of one call (work_bound;
    None where no `_roofline` metric is read or the card has no peaks)."""

    walls_ms: list
    enqueue_ms: list
    windows: list
    bound: dict | None = None

    @property
    def calls(self) -> int:
        return sum(w.calls for w in self.windows)

    @property
    def device(self) -> list:
        return [r for w in self.windows for r in w.device]

    def busy_window_s(self):
        bw = [devtrace.busy_window_us(w) for w in self.windows]
        return sum(b for b, _ in bw) / 1e6, sum(w for _, w in bw) / 1e6

    def idle_pct(self):
        """Share of the windows, from each one's first device record to its
        last, in which no operation ran on the card, in %."""
        busy, span = self.busy_window_s()
        return 100.0 * (1.0 - busy / span) if span > 0 else None

    def kernel_ms(self, name, inside=True):
        """Device ms a call in records whose name holds `name` (inside) or
        in all the others; None where no record holds it."""
        if not any(name in n for n, _, _ in self.device):
            return None
        ms = sum((e - s) / 1e3 for n, s, e in self.device
                 if (name in n) == inside)
        return ms / self.calls


def peaks(card: str):
    table = json.loads((BENCH / "peaks.json").read_text())
    return table.get(card)


def work_bound(cell, soup_np, batches, seed, card):
    """The roofline's bound of one call (workcount.py): box and triangle
    tests of a seeded sample of each batch, scaled to the batch, averaged
    over the batches the calls rotate through."""
    pk = peaks(card)
    if pk is None:
        return None
    b = cell["config"]["build"]
    dev = batches[0]["origin"].device
    tree = workcount.build_lbvh(soup_np, b["leaf_size"], b["width"])
    tree = workcount.Tree(**{k: (v.to(dev) if torch.is_tensor(v) else v)
                             for k, v in vars(tree).items()})
    host = generate.rng(seed, WORK)
    per = max(1, WORK_RAYS // len(batches))
    picks = [torch.as_tensor(np.sort(host.choice(x["origin"].shape[0],
                                                 min(per,
                                                     x["origin"].shape[0]),
                                                 replace=False)),
                             device=dev) for x in batches]
    cat = {k: torch.cat([x[k][p] for x, p in zip(batches, picks)])
           for k in ("origin", "direction", "min_t", "max_t")}
    boxes, tests, _ = workcount.count(tree, cat["origin"], cat["direction"],
                                      cat["min_t"], cat["max_t"])
    box = tri = 0.0
    at = 0
    for x, p in zip(batches, picks):
        k = p.numel()
        scale = x["origin"].shape[0] / k / len(batches)
        box += float(boxes[at:at + k].double().sum()) * scale
        tri += float(tests[at:at + k].double().sum()) * scale
        at += k
    rays = sum(x["origin"].shape[0] for x in batches) / len(batches)
    ops = box * workcount.OPS_PER_BOX + tri * workcount.OPS_PER_TRI
    nbytes = (rays * workcount.BYTES_PER_RAY
              + soup_np.shape[0] * workcount.BYTES_PER_TRI)
    t_ops = ops / pk["f32_instr_per_s"] * 1e3
    t_bytes = nbytes / pk["bytes_per_s"] * 1e3
    return {"ms": max(t_ops, t_bytes),
            "by": "operations" if t_ops >= t_bytes else "bytes",
            "box_tests": box, "tri_tests": tri}


def run_window(call, batches, seconds, keep, seed, sync):
    """The closed loop -> (walls_ms, enqueue_ms, rays, window_s, kept)."""
    host = generate.rng(seed, KEEP)
    walls, enq, kept = [], [], []
    rays = 0
    sync()
    start = time.perf_counter()
    end = start + seconds
    last = start
    i = 0
    while last < end:
        b = i % len(batches)
        t0 = time.perf_counter()
        rec = call(b)
        t1 = time.perf_counter()
        sync()
        last = time.perf_counter()
        walls.append((last - t0) * 1e3)
        enq.append((t1 - t0) * 1e3)
        rays += batches[b]["origin"].shape[0]
        if len(kept) < keep:
            kept.append((b, rec))
        else:
            j = int(host.integers(0, i + 1))
            if j < keep:
                kept[j] = (b, rec)
        i += 1
    return walls, enq, rays, last - start, kept


def run_cell(root: Path, name: str, seed: int, seconds: float, trace: bool,
             device: str, t_start: float, log=print, program=None):
    """One run of cell `name` -> the result line's dict.  t_start: where
    set-up's clock starts, on time.perf_counter's clock.  program: the
    system under test (default: the query kind's Program, the port); a
    test hands in a broken one."""
    cell = load_cell(root, name)
    query = query_of(cell)
    cuda = device == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    traffic = cell["traffic"]
    positions, indices = scene_of(cell)
    soup_np = np.asarray(positions, np.float32)[np.asarray(indices)]
    scene_s = time.perf_counter() - t_start
    t0 = time.perf_counter()
    prog = (program or query.Program)(cell, positions, indices, device)
    sync()
    build_s = time.perf_counter() - t0
    soup = torch.as_tensor(soup_np, device=device)
    batches = generate.make(traffic, seed, soup, device,
                            root / "rtbench" / "traffic" / "kinds")
    rays = [prog.rays(x) for x in batches]

    def call(b):
        return prog(rays[b])

    t0 = time.perf_counter()
    for _ in range(2):
        for b in range(len(batches)):
            call(b)
        sync()
    warm_s = time.perf_counter() - t0
    # Set-up's garbage is collected and set aside, so that the window's
    # collections scan only what the window itself allocates.
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t_start
    n = batches[0]["origin"].shape[0]
    log(f"cell {name}: config {cell['workload']['config']}, traffic "
        f"{cell['workload']['traffic']}, {soup_np.shape[0]} triangles, "
        f"{len(batches)} batches of {n} rays, seed {seed}")
    log(f"set-up {setup_s:.3f} s: to the scene's soup {scene_s:.3f} s "
        f"(the generator), scene build and pack {build_s:.3f} s, warm-up "
        f"{warm_s:.3f} s")
    for line in getattr(prog, "notes", lambda n: [])(n):
        log(line)
    card = torch.cuda.get_device_name() if cuda else "cpu"
    if cuda:
        log(f"card: {smi()}")
        torch.cuda.reset_peak_memory_stats()
    keep = int(traffic["check"]["calls"])
    walls, enq, n_rays, window_s, kept = run_window(call, batches, seconds,
                                                    keep, seed, sync)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    gc.unfreeze()
    log(f"window {window_s:.3f} s, {len(walls)} calls, {n_rays} rays; "
        f"memory_peak_bytes {peak}")
    pct = (50, 90, 95, 99, 100)
    log(f"call ms p{pct}: {np.percentile(walls, pct).round(4).tolist()}; "
        f"enqueue ms: {np.percentile(enq, pct).round(4).tolist()}")
    # A call that raises ends the run with no result, so a result counts
    # no failed call.
    result = {"correct": False, "attempted": len(walls), "failed": 0,
              "metrics": {}, "device": {
                  "platform": "gpu" if cuda else device, "kind": card,
                  "count": int(cell["workload"]["chips"]),
                  "memory_peak_bytes": int(peak)}}
    if trace:
        windows = []
        if cuda:
            per = max(TRACE_CALLS[0], min(TRACE_CALLS[1], math.ceil(
                TRACE_CALL_S * 1e3 / float(np.median(walls)))))
            turn = iter(range(1 << 62))

            def one():
                b = next(turn) % len(batches)
                with torch.profiler.record_function("rtbench.call"):
                    call(b)
                with torch.profiler.record_function("rtbench.sync"):
                    sync()

            windows = devtrace.clean_windows(one, per)
        bound = None
        if any(m["name"].endswith("_roofline") for m in cell["per_layer"]):
            bound = work_bound(cell, soup_np, batches, seed, card)
            log(f"bound {json.dumps(bound)}")
        readings = Readings(walls, enq, windows, bound)
        for m in cell["per_layer"]:
            val = load_module(root / "rtbench" / "metrics" /
                              f"{m['name']}.py").read(readings)
            if val is not None:
                result["metrics"][m["name"]] = {"value": val,
                                                "unit": m["unit"]}
        if windows:
            busy, span = readings.busy_window_s()
            result["device"].update(busy_s=busy, window_s=span)
            result["breakdown"] = {
                "device_ops": [list(x) for x in
                               devtrace.device_ops(windows)[:devtrace.TOP]],
                "idle_gaps": [list(x) for x in
                              devtrace.idle_gaps(windows)[:devtrace.TOP]]}
            log(f"trace: {len(windows)} clean windows of {windows[0].calls} "
                f"calls, spins lost {[devtrace.PAD_SPINS - w.lead for w in windows]}")
    else:
        values = {
            "mrays_per_s": n_rays / window_s / 1e6,
            "call_ms_p95": float(np.percentile(walls, 95)),
            "setup_s": setup_s,
        }
        for m in cell["end_to_end"]:
            result["metrics"][m["name"]] = {"value": values[m["name"]],
                                            "unit": m["unit"]}
    del prog, rays, call
    if cuda:
        torch.cuda.empty_cache()
    numbers = query.check(cell, kept, batches, soup, seed)
    limits = traffic["check"]["limits"]
    result["correct"] = all(numbers[k] <= limits[k] for k in query.CHECKS)
    result["checks"] = {k: {"value": numbers[k], "limit": limits[k]}
                        for k in query.CHECKS}
    return result

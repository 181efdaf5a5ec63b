"""Time BASELINE config 5's instanced trace and its 4-bounce wavefront on
the card, for one checkout of rtk_tpu_torch or several in turn.

    python3 tools/torch_instanced_probe.py --tree parent=_chipcheck/parent \
        --tree tree=. [--pairs 12] [--seeds 11 12 13] [--out out/instanced.jsonl]

Each --tree name=path is a checkout holding rtk_tpu_torch/ and
chip_smoke.py.  Every tree runs in a process of its own (so the packages do
not mix), started together; each builds config 5 once with that
checkout's chip_smoke.config5 (125 x blob(6), LBVH and SAH forests, 1024^2
rays) and calibrates the wavefront's pooled caps, then waits.  The trees
then take --pairs rounds in turn, in the order given and in reverse on
alternate rounds (a, b, b, a, a, b, ...), one tree on the card at a time.
A round times, per forest, what chip_smoke.py phases 5 and 9c time:
trace_closest_instanced_packets with 12 candidates (CUDA events around 3
calls after a warm one), and chip_smoke.wavefront4 with those caps (host
clock with a synchronise, one run per seed).  One JSON line a round, with
the card's name and power limit, then a summary line: per tree, forest and
metric (the call's ms, the median of a round's wavefront runs) the
quartiles over the rounds, and with two trees, how many rounds the second
tree was the faster of each adjacent pair and the quartiles of its
difference (second - first, ms).  Needs a CUDA device; imports no jax.
"""
import argparse
import json
import os
import statistics
import subprocess
import sys
import time

TAG = "PROBE "  # the children's protocol lines on their standard output


def setup():
    import numpy as np
    import torch

    import chip_smoke as cs
    import rtk_tpu_torch as rt
    from rtk_tpu_torch import instancing
    from rtk_tpu_torch.testing import scenes

    if not torch.cuda.is_available():
        raise SystemExit("torch_instanced_probe.py needs a CUDA device")
    dev = torch.device("cuda")
    _, tf, iscene, tables = cs.config5(rt, dev)
    rays = scenes.camera_rays(**cs.INST_CAM, width=1024, height=1024,
                              order="morton", device=dev, on_device=True)
    box = (torch.tensor(tf[:, :, 3].min(axis=0) - 1.0, device=dev),
           torch.tensor(tf[:, :, 3].max(axis=0) + 2.0, device=dev))
    caps = {}
    for name, ps in tables.items():
        col = []
        cs.wavefront4(rt, ps, rays, box, 5, collect=col)
        caps[name] = instancing.caps_from_counts(
            np.max(np.stack(col), axis=0), rays.count,
            iscene.num_instances, p_pk=16)
    return dict(cs=cs, rt=rt, torch=torch, tables=tables, rays=rays, box=box,
                caps=caps)


def probe_round(st, seeds):
    cs, rt, torch, rays = st["cs"], st["rt"], st["torch"], st["rays"]
    out = {"rays": rays.count, "card": cs.smi("name,power.limit")}
    for name, ps in st["tables"].items():
        _, call_ms = cs.timed(lambda: rt.trace_closest_instanced_packets(
            ps, rays, max_candidates=cs.INST_CANDIDATES), reps=3)
        wave_ms = []
        for seed in seeds:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            cs.wavefront4(rt, ps, rays, st["box"], seed,
                          caps=st["caps"][name])
            wave_ms.append((time.perf_counter() - t0) * 1e3)
        out[name] = {"instanced_call_ms": call_ms, "wavefront_ms": wave_ms}
    return out


def child(path, seeds):
    """One tree in this process: set up, then one round per line read."""
    sys.path.insert(0, os.path.abspath(path))
    st = setup()
    print(TAG + "ready", flush=True)
    for _ in sys.stdin:
        print(TAG + json.dumps(probe_round(st, seeds)), flush=True)


def read_tagged(proc, name):
    for line in proc.stdout:
        if line.startswith(TAG):
            return line[len(TAG):].strip()
    raise SystemExit(f"tree {name}: its process ended "
                     f"(rc {proc.wait()})")


def quartiles(xs):
    if len(xs) < 2:
        return [xs[0]] * 3
    return statistics.quantiles(xs, n=4, method="inclusive")


def summary(recs, names):
    """Quartiles per tree and metric; wins and differences between the
    two trees of each round (the rounds are adjacent in time)."""
    metrics = {"instanced_call_ms": lambda r: r["instanced_call_ms"],
               "wavefront_median_ms":
                   lambda r: statistics.median(r["wavefront_ms"])}
    forests = [k for k in recs[0] if isinstance(recs[0][k], dict)]
    out = {"rounds": len(recs) // len(names)}
    for f in forests:
        for m, get in metrics.items():
            vals = {n: [get(r[f]) for r in recs if r["tree"] == n]
                    for n in names}
            row = {n: {"q1_median_q3": quartiles(v)} for n, v in vals.items()}
            if len(names) == 2:
                a, b = names
                diff = [y - x for x, y in zip(vals[a], vals[b])]
                row[f"{b}_faster_rounds"] = sum(d < 0 for d in diff)
                row[f"{b}_minus_{a}_q1_median_q3"] = quartiles(diff)
            out[f"{f}.{m}"] = row
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", action="append", default=[],
                    metavar="NAME=PATH")
    ap.add_argument("--pairs", type=int, default=2,
                    help="rounds per tree, alternating the order")
    ap.add_argument("--seeds", type=int, nargs="+", default=[11, 12, 13])
    ap.add_argument("--out")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        child(args.child, args.seeds)
        return 0
    trees = [t.split("=", 1) for t in args.tree] or [["tree", "."]]
    names = [n for n, _ in trees]
    procs = {name: subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--child", path,
         "--seeds", *map(str, args.seeds)],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
        for name, path in trees}
    recs, lines = [], []
    try:
        for name, proc in procs.items():
            read_tagged(proc, name)
        for i in range(args.pairs):
            for name in (names if i % 2 == 0 else names[::-1]):
                procs[name].stdin.write("go\n")
                procs[name].stdin.flush()
                rec = {"tree": name, "round": i,
                       **json.loads(read_tagged(procs[name], name))}
                recs.append(rec)
                lines.append(json.dumps(rec))
                print(lines[-1], flush=True)
    finally:
        for proc in procs.values():
            proc.stdin.close()
        for proc in procs.values():
            proc.wait()
    # Each round's records in the order the trees were given, so that
    # the difference pairs the two trees of one round.
    recs.sort(key=lambda r: (r["round"], names.index(r["tree"])))
    lines.append(json.dumps({"summary": summary(recs, names)}))
    print(lines[-1], flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())

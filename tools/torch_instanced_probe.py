"""Time BASELINE config 5's instanced trace and its 4-bounce wavefront on
the card, for one checkout of rtk_tpu_torch or several in turn.

    python3 tools/torch_instanced_probe.py --tree parent=_chipcheck/parent \
        --tree tree=. [--seeds 11 12 13] [--out out/instanced.jsonl]

Each --tree name=path is a checkout holding rtk_tpu_torch/ and
chip_smoke.py.  Every tree runs in a process of its own (so the packages do
not mix), in the order given and then in reverse (a, b, b, a).  A run
builds config 5 with that checkout's chip_smoke.config5 (125 x blob(6),
LBVH and SAH forests, 1024^2 rays) and, per forest, times what
chip_smoke.py phases 5 and 9c time: trace_closest_instanced_packets with
12 candidates (CUDA events around 3 calls after a warm one), and
chip_smoke.wavefront4 with pooled calibrated caps (host clock with a
synchronise, one run per seed after a calibrating one).  One JSON line a
run, with the card's name and power limit.  Needs a CUDA device; imports
no jax.
"""
import argparse
import json
import os
import subprocess
import sys
import time


def probe(seeds):
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
    out = {"rays": rays.count, "card": cs.smi("name,power.limit")}
    for name, ps in tables.items():
        _, call_ms = cs.timed(lambda: rt.trace_closest_instanced_packets(
            ps, rays, max_candidates=cs.INST_CANDIDATES), reps=3)
        col = []
        cs.wavefront4(rt, ps, rays, box, 5, collect=col)
        caps = instancing.caps_from_counts(
            np.max(np.stack(col), axis=0), rays.count,
            iscene.num_instances, p_pk=16)
        wave_ms = []
        for seed in seeds:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            cs.wavefront4(rt, ps, rays, box, seed, caps=caps)
            wave_ms.append((time.perf_counter() - t0) * 1e3)
        out[name] = {"instanced_call_ms": call_ms, "wavefront_ms": wave_ms}
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", action="append", default=[],
                    metavar="NAME=PATH")
    ap.add_argument("--seeds", type=int, nargs="+", default=[11, 12, 13])
    ap.add_argument("--out")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:  # one tree, in this process
        sys.path.insert(0, os.path.abspath(args.child))
        print(json.dumps(probe(args.seeds)))
        return 0
    trees = [t.split("=", 1) for t in args.tree] or [["tree", "."]]
    lines = []
    for name, path in (trees + trees[::-1] if len(trees) > 1 else trees):
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child", path,
             "--seeds", *map(str, args.seeds)],
            check=True, capture_output=True, text=True)
        rec = {"tree": name, **json.loads(proc.stdout.splitlines()[-1])}
        lines.append(json.dumps(rec))
        print(lines[-1], flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())

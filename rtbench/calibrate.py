"""The readings the check's limits are set from, for one cell.

    python3 rtbench/calibrate.py --workload <name> --seeds <a> <b> ... \
        [--seconds 2] [--out chiprun_out/calibrate.jsonl]

In one process (the scene is built once): for each seed, the cell's
batches, a short window of the timed call at the cell's own sizes and
load, and the check's numbers on the calls kept (the program's
readings); then the control on the same sampled rays: the plain
reference computed in bfloat16, the precision below the configuration's
float32, put in the program's place.  One JSON line a seed.  The
benchmark's own runs never run this.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[0] = str(ROOT)


def main(argv=None, root=ROOT) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    import numpy as np
    import torch

    from rtbench import harness
    from rtbench.traffic import generate

    cell = harness.load_cell(root, args.workload)
    query = harness.query_of(cell)
    positions, indices = harness.scene_of(cell)
    soup_np = np.asarray(positions, np.float32)[np.asarray(indices)]
    prog = query.Program(cell, positions, indices, args.device)
    soup = torch.as_tensor(soup_np, device=args.device)
    cuda = args.device == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    keep = int(cell["traffic"]["check"]["calls"])
    out = open(args.out, "a") if args.out else None
    for seed in args.seeds:
        t0 = time.perf_counter()
        batches = generate.make(cell["traffic"], seed, soup, args.device,
                                root / "rtbench" / "traffic" / "kinds")
        rays = [prog.rays(x) for x in batches]
        for r in rays:
            prog(r)
        walls, _, n_rays, window_s, kept = harness.run_window(
            lambda b: prog(rays[b]), batches, args.seconds, keep, seed, sync)
        line = {"workload": args.workload, "seed": seed,
                "calls": len(walls), "mrays_per_s": n_rays / window_s / 1e6,
                "program": query.check(cell, kept, batches, soup, seed),
                "control_bf16": query.check(cell, kept, batches, soup, seed,
                                            dtype=torch.bfloat16),
                "hit_share": float(sum(float(r[0].float().mean())
                                       for _, r in kept) / len(kept)),
                "seconds": time.perf_counter() - t0}
        print(json.dumps(line), flush=True)
        if out:
            out.write(json.dumps(line) + "\n")
            out.flush()
        del batches, rays, kept
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())

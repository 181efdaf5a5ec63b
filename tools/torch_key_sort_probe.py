"""Time the coherence key and the stable sort of trace_packets' front end
on the card, for one checkout of rtk_tpu_torch or several in turn.

    python3 tools/torch_key_sort_probe.py --tree parent=_chipcheck/parent \
        --tree tree=. [--width 8192] [--reps 5] [--out out/keys.jsonl]

Each --tree name=path is a checkout holding rtk_tpu_torch/.  Every tree
runs in a process of its own (so the packages do not mix), in the order
given and then in reverse (a, b, b, a), on width^2 morton-ordered camera
rays of the headline camera made on the card.  Per run, one JSON line:
the key's dtype and bytes, ms of ray_coherence_key, of torch.sort(key,
stable=True), of the gather of the (8, N) rows through the order and of
the whole Tracer.closest on build_scene(blob(6)) (chip_smoke.py phase
3's scene), CUDA events around `reps` calls after a warm one, and the
card's name and power limit.  Needs a CUDA device; imports no jax.
"""
import argparse
import json
import os
import subprocess
import sys

CAM = dict(eye=(0, 0, 3.0), look_at=(0, 0, 0), up=(0, 1, 0), fov_deg=45)


def probe(width, reps):
    import torch

    import rtk_tpu_torch as rt
    from rtk_tpu_torch.ops.morton import ray_coherence_key
    from rtk_tpu_torch.testing import scenes

    if not torch.cuda.is_available():
        raise SystemExit("torch_key_sort_probe.py needs a CUDA device")

    def timed(fn):
        fn()
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(reps):
            out = fn()
        end.record()
        torch.cuda.synchronize()
        return out, start.elapsed_time(end) / reps

    rays = scenes.camera_rays(**CAM, width=width, height=width,
                              order="morton", device="cuda", on_device=True)
    key, key_ms = timed(lambda: ray_coherence_key(rays.origin,
                                                  rays.direction))
    order, sort_ms = timed(lambda: torch.sort(key, stable=True).indices)
    rows = torch.cat([rays.origin.T, rays.direction.T, rays.min_t[None],
                      rays.max_t[None]])
    _, gather_ms = timed(lambda: rows[:, order].contiguous())
    del rows
    v6, f6 = scenes.blob(6)[1:]
    tracer = rt.Tracer(rt.build_scene((v6, f6), device="cuda"))
    _, closest_ms = timed(lambda: tracer.closest(rays))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip()
    return {"rays": rays.count, "key_dtype": str(key.dtype),
            "key_bytes": key.element_size() * key.numel(),
            "key_ms": key_ms, "sort_ms": sort_ms, "gather_ms": gather_ms,
            "closest_ms": closest_ms,
            "key_checksum": int(key.sum(dtype=torch.int64)),
            "order_checksum": int((order * torch.arange(
                order.numel(), device=order.device) % 1000003).sum()),
            "card": card}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", action="append", default=[],
                    metavar="NAME=PATH")
    ap.add_argument("--width", type=int, default=8192)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:  # one tree, in this process
        sys.path.insert(0, os.path.abspath(args.child))
        print(json.dumps(probe(args.width, args.reps)))
        return 0
    trees = [t.split("=", 1) for t in args.tree] or [["tree", "."]]
    lines = []
    for name, path in (trees + trees[::-1] if len(trees) > 1 else trees):
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child", path,
             "--width", str(args.width), "--reps", str(args.reps)],
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

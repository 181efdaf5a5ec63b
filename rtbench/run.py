"""Run one cell of BENCHMARK.json once and print its result line.

    python3 rtbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the cell's chips.  The
earlier lines of standard output describe the run; the last is one JSON
object: correct, attempted, failed, metrics, device (and with --trace 1,
breakdown), then checks, each number compared beside its limit, which
also end standard error.  Exits non-zero with no result line when CUDA is
missing or has fewer cards than the cell asks for, when the program is
not in the checkout, or when jax, jaxlib, flax or rtk_tpu were loaded.
"""
import os
import time


def _process_age() -> float:
    """Seconds since this process started (from /proc; 0 where absent)."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return max(0.0, up - int(fields[19]) / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


T_START = time.perf_counter() - _process_age()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# The checkout's root, not this folder, is where imports resolve.
sys.path[0] = str(ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    chips = {w["name"]: w["chips"] for w in bench["workloads"]}
    if args.workload not in chips:
        print(f"no workload {args.workload!r}", file=sys.stderr)
        return 2
    import torch

    t_torch = time.perf_counter() - T_START
    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < chips[args.workload]):
        print(f"needs {chips[args.workload]} CUDA device(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    # Set-up's clock starts here: torch's import and the CUDA context are
    # the environment's; the program's import and all it does after are
    # set-up.
    t_setup = time.perf_counter()
    print(f"process start to torch imported {t_torch:.3f} s, to a CUDA "
          f"context {t_setup - T_START:.3f} s (before setup_s)", flush=True)
    from rtbench import harness

    result = harness.run_cell(ROOT, args.workload, args.seed, args.seconds,
                              bool(args.trace), "cuda", t_setup)
    bad = harness.forbidden_modules()
    if bad:
        print(f"loaded modules the run must not load: {bad}", file=sys.stderr)
        return 3
    for k, v in result["checks"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    print(f"correct {result['correct']}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

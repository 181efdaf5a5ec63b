"""The check fails a run whose timed path is broken: a whole run of a
tiny cell on the CPU with the program's answers altered where they are
produced, half of each batch left out, or the plain reference computed in
bfloat16 in the program's place (the control).  The cells have no state
that a step could leave unchanged and no exchange between chips."""
import time

import pytest
import torch

from rtbench import harness, reference
from rtbench.queries import closest
from rtbench.tests import tiny


class Broken(closest.Program):
    fault = None

    def __call__(self, rays):
        hit, t, u, v, tri, mesh = super().__call__(rays)
        if self.fault == "t":
            t = torch.where(hit, t * (1 + 1e-3), t)
        elif self.fault == "triangle":
            tri = torch.where(hit, tri + 1, tri)
        elif self.fault == "uv":
            u, v = v, u
        elif self.fault == "half":
            n = hit.shape[0] // 2
            half = super().__call__(rays[:n])
            hit, t, u, v, tri, mesh = (
                torch.cat([a, b[n:]]) for a, b in zip(half, (
                    torch.zeros_like(hit), rays.max_t, torch.zeros_like(u),
                    torch.zeros_like(v), torch.full_like(tri, -1),
                    torch.full_like(mesh, -1))))
        return hit, t, u, v, tri, mesh


class Control(closest.Program):
    """The plain reference in bfloat16 in the program's place."""

    def __init__(self, cell, positions, indices, device):
        super().__init__(cell, positions, indices, device)
        self.soup = torch.as_tensor(positions[indices], device=device)

    def __call__(self, rays):
        hit, t, u, v, idx = reference.closest(
            self.soup, rays.origin, rays.direction, rays.min_t, rays.max_t,
            dtype=torch.bfloat16)
        i32 = idx.to(torch.int32)
        return hit, t, u, v, i32, torch.where(hit, 0, -1).to(torch.int32)


def run(program, cell):
    root = tiny.make_root(run.tmp)
    return harness.run_cell(root, cell, 3_000_000_019, 0.3, False, "cpu",
                            time.perf_counter(), log=lambda *_: None,
                            program=program)


@pytest.mark.parametrize("cell", ["tiny-primary", "tiny-bounce"])
@pytest.mark.parametrize("fault", ["t", "triangle", "uv", "half"])
def test_fault_is_not_correct(tmp_path, fault, cell):
    run.tmp = tmp_path
    prog = type("P", (Broken,), {"fault": fault})
    r = run(prog, cell)
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("cell", ["tiny-primary", "tiny-bounce"])
def test_control_is_not_correct(tmp_path, cell):
    run.tmp = tmp_path
    r = run(Control, cell)
    assert not r["correct"], r["checks"]
    assert r["checks"]["t_gap"]["value"] > 10 * r["checks"]["t_gap"]["limit"]


def test_calibrate_reads_program_and_control(tmp_path, capsys):
    from rtbench import calibrate

    root = tiny.make_root(tmp_path)
    out = tmp_path / "cal.jsonl"
    calibrate.main(["--workload", "tiny-primary", "--seeds", "8", "9",
                    "--seconds", "0.2", "--device", "cpu", "--out",
                    str(out)], root=root)
    import json

    lines = [json.loads(x) for x in out.read_text().splitlines()]
    limits = tiny.LIMITS
    for line in lines:
        assert all(line["program"][k] <= limits[k] for k in limits)
        assert any(line["control_bf16"][k] > limits[k] for k in limits)

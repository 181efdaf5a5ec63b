"""utils/costmodel.py against rtk_tpu's: the same public names and
signatures, the same formula (given the reference's constants, the same
numbers), an aligned and monotone auto_pkt, dispatch_bound's two regimes
with the card's constants, the card's fit anchors, and the fit of
tools/torch_costmodel_fit.py on rows made from known constants."""
import importlib.util
import inspect
import os

import pytest

from rtk_tpu.utils import costmodel as jcm
from rtk_tpu_torch.utils import costmodel as cm

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# The card's sweep (tools/torch_costmodel_fit.py on an NVIDIA H100 80GB
# HBM3 at 700.00 W, the run the module's constants come from): side, host
# wall ms of one synchronised Tracer.closest on side^2 blob(6) Morton
# primaries (median of 31 calls, then of 5 processes) and steps_per_block.
# The fit's sizes only.
FIT_ANCHORS = [(1024, 0.8832, 21.162), (2048, 2.2936, 19.6009),
               (4096, 7.4209, 18.6117), (8192, 26.6773, 18.013)]
# The fit's largest relative error over those sizes in that run (2.8% at
# 2048^2), rounded up: the model must give them back within it.
ANCHOR_TOL = 0.03

FITTED = {"steps_per_block"}  # dispatch_bound's default: the card's own


def _ref_and_port(name):
    get = lambda m: (getattr(m.StepModel, name.split(".")[1])  # noqa: E731
                     if name.startswith("StepModel.") else getattr(m, name))
    return inspect.signature(get(jcm)), inspect.signature(get(cm))


@pytest.mark.parametrize("name", ["StepModel", "StepModel.step_us",
                                  "StepModel.trace_ms", "auto_pkt",
                                  "dispatch_bound"])
def test_signatures_match_reference(name):
    ref, port = _ref_and_port(name)
    assert list(ref.parameters) == list(port.parameters)
    assert ref.return_annotation == port.return_annotation
    for (pn, rp), pp in zip(ref.parameters.items(),
                            port.parameters.values()):
        assert (rp.kind, rp.annotation) == (pp.kind, pp.annotation), pn
        if name == "StepModel":
            # The dataclass's defaults are the module's fitted constants.
            assert pp.default == getattr(cm, pn.upper()), pn
        elif pn not in FITTED:
            assert rp.default == pp.default, pn


def test_public_names_match_reference():
    public = lambda m: {n for n in vars(m) if not n.startswith("_")  # noqa
                        and n not in ("annotations", "dataclasses")}
    assert public(jcm) <= public(cm)
    assert public(cm) - public(jcm) <= {"PKT"}


def test_constants_are_the_cards():
    ours = (cm.A_US, cm.B_US, cm.C_US, cm.DISPATCH_MS)
    theirs = (jcm.A_US, jcm.B_US, jcm.C_US, jcm.DISPATCH_MS)
    assert all(x >= 0 for x in ours)
    assert cm.B_US > 0 and cm.DISPATCH_MS > 0
    assert all(a != b for a, b in zip(ours[1:], theirs[1:]))


GRID = [(p, pkt, n, steps) for (p, pkt) in ((8, 128), (8, 512), (16, 256),
                                            (32, 128), (8, 2048))
        for n, steps in ((100, 34.0), (2 ** 20, 37.0), (67 * 2 ** 20, 16.0))]


@pytest.mark.parametrize("p,pkt,n_rays,steps", GRID)
def test_formula_matches_reference(p, pkt, n_rays, steps):
    """With the reference's A, B, C the port's model gives the reference's
    step time and device time (trace_ms less each module's DISPATCH_MS)."""
    ref = jcm.StepModel()
    port = cm.StepModel(a_us=jcm.A_US, b_us=jcm.B_US, c_us=jcm.C_US)
    assert port.step_us(p, pkt) == pytest.approx(ref.step_us(p, pkt),
                                                 rel=1e-12)
    want = ref.trace_ms(n_rays, pkt, steps, p) - jcm.DISPATCH_MS
    got = port.trace_ms(n_rays, pkt, steps, p) - cm.DISPATCH_MS
    assert got == pytest.approx(want, rel=1e-12)


def test_auto_pkt_monotone_and_aligned():
    prev = 0
    for n in (1, 1000, 8 * 512, 4096, 10 ** 6, 4 * 2 ** 20, 32 * 2 ** 20,
              67 * 2 ** 20, 2 ** 31):
        pkt = cm.auto_pkt(n)
        assert pkt % 128 == 0 and pkt >= 128
        assert pkt >= prev
        assert cm.auto_pkt(n, p=16) == pkt
        prev = pkt
    # The width packet_roots is laid out in by default: misaligns nothing.
    from rtk_tpu_torch.ops.packet_trace import PKT
    assert cm.auto_pkt(67 * 2 ** 20) == PKT


def test_dispatch_bound_regimes():
    assert cm.dispatch_bound(64 * 64)          # host's fixed cost
    assert not cm.dispatch_bound(8192 * 8192)  # the card's work
    assert cm.dispatch_bound(64 * 64, pkt=512, steps_per_block=40.0)
    # The answer flips once as batches grow.
    answers = [cm.dispatch_bound(4 ** k) for k in range(4, 14)]
    assert answers == sorted(answers, reverse=True)


@pytest.mark.parametrize("side,wall_ms,steps", FIT_ANCHORS)
def test_step_model_matches_fit_anchors(side, wall_ms, steps):
    n = side * side
    got = cm.StepModel().trace_ms(n, cm.auto_pkt(n), steps)
    assert abs(got - wall_ms) / wall_ms < ANCHOR_TOL, (side, got, wall_ms)


def _fit_tool():
    spec = importlib.util.spec_from_file_location(
        "torch_costmodel_fit", os.path.join(REPO, "tools",
                                            "torch_costmodel_fit.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("b_us,dispatch", [(3e-5, 0.4), (1.2e-4, 2.0)])
def test_fit_recovers_known_constants(b_us, dispatch):
    """Walls made from a known b and dispatch cost give them back, the
    dispatch cost as the fit's intercept, with A and C 0: each wall stands
    for P = 8 at both PKT = 128 and 512 (pkt selects nothing on the card),
    so a per-packet-step term cannot fit both rows of a size."""
    tool = _fit_tool()
    rows = []
    for side, spb in ((1024, 30.0), (2048, 27.0), (4096, 24.0),
                      (8192, 22.0)):
        n = side * side
        wall = dispatch + n // 1024 * spb * (b_us * 8 * 128) / 1e3
        rows.append({"rays": n, "wall_ms": wall, "steps_per_block": spb})
    a, b, c, d = tool.fit(rows)
    assert a == 0.0
    assert b == pytest.approx(b_us, rel=1e-9)
    assert c == pytest.approx(0.0, abs=1e-9)
    assert d == pytest.approx(dispatch, rel=1e-9)
    # A wall that falls short of the dispatch cost: no negative term.
    rows[0] = {**rows[0], "wall_ms": dispatch * 0.5}
    a, b, c, d = tool.fit(rows)
    assert a == 0.0 and b >= 0 and c >= 0 and d >= 0

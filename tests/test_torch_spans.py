"""The port's spans (utils/stats.py::span): a shared null context and no
profiler call while nothing records; under a profiler, one span of each
stage of a call, nested by the profiler as the call nests, in the call's
order, and the lazy record's gathers after the call's root; a frame's
refit and repack (`rtk.refit`, `rtk.repack`) ahead of its trace; an
instanced frame's `rtk.instanced.*` inside its `rtk.path.trace`."""
import numpy as np
import pytest
import torch

import rtk_tpu_torch as rt
from rtk_tpu_torch import instancing
from rtk_tpu_torch.ops import packet_trace as pt
from rtk_tpu_torch.testing import scenes
from rtk_tpu_torch.utils import stats

torch.set_num_threads(2)

FIELDS = ("mesh_index", "triangle_index", "vertex_position", "vertex_index",
          "u", "v")
# The spans of a sorted closest call and its record's reads, in the order
# they start; every rtk.packet_trace.* span's parent is rtk.packet_trace,
# whose parent is the root.
ROOT = "rtk.tracer.closest"
FRONT = "rtk.packet_trace"
STEPS = tuple(f"{FRONT}.{s}" for s in ("key", "sort", "rows", "launch",
                                       "unsort", "wrap"))
HITS = tuple(f"rtk.hits.{f}" for f in ("mesh_index", "triangle_index",
                                       "vertex_position", "vertex_index",
                                       "uv"))
SORTED_ONLY = {f"{FRONT}.{s}" for s in ("key", "sort", "unsort")}
REFIT = ("rtk.refit", "rtk.repack")  # a frame's refit, then its repack


@pytest.fixture(scope="module")
def tracer():
    v, f = scenes.blob(2)[1:]
    return rt.Tracer(rt.build_scene((v, f), device="cpu"),
                     config=rt.TraceConfig(defer_uv=True))


def _rays(side=16):
    return scenes.camera_rays((0, 0, 3.0), (0, 0, 0), (0, 1, 0), 45, side,
                              side, device="cpu")


def _spans(prof):
    return [e for e in prof.events() if e.name.startswith("rtk.")]


def test_no_profiler_no_profiler_range(tracer, monkeypatch):
    assert not torch.autograd._profiler_enabled()
    assert stats.span("rtk.a") is stats.span("rtk.b")

    def refuse(name):
        raise AssertionError(f"a profiler range {name!r} with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    monkeypatch.setattr(pt, "SORT_RAYS_MIN", 1)
    h = tracer.closest(_rays())
    got = [getattr(h, f) for f in FIELDS]
    assert bool(h.hit.any())
    assert torch.equal(got[1], torch.where(h.hit, h.triangle_index, -1))


def test_sorted_call_spans(tracer, monkeypatch, tmp_path):
    monkeypatch.setattr(pt, "SORT_RAYS_MIN", 1)
    rays = _rays()
    with stats.profiler_trace(str(tmp_path)) as prof:
        h = tracer.closest(rays)
        for f in FIELDS[:5]:  # .u recomputes u and v: one rtk.hits.uv
            getattr(h, f)
    spans = _spans(prof)
    assert [e.name for e in spans] == [ROOT, FRONT, *STEPS, *HITS]
    starts = [e.time_range.start for e in spans]
    assert starts == sorted(starts)
    by = {e.name: e for e in spans}
    assert by[ROOT].cpu_parent is None
    assert by[FRONT].cpu_parent.name == ROOT
    assert all(by[s].cpu_parent.name == FRONT for s in STEPS)
    for name in HITS:
        assert by[name].cpu_parent is None
        assert by[name].time_range.start >= by[ROOT].time_range.end
    # The spans equal the call they time: the same records as untraced.
    assert torch.equal(h.t, tracer.closest(rays).t)
    assert "rtk.packet_trace.launch" in (tmp_path / "trace.json").read_text()


@pytest.mark.parametrize("mode", ["closest", "any"])
def test_unsorted_call_spans(tracer, mode):
    rays = _rays()
    assert rays.count < pt.SORT_RAYS_MIN
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        getattr(tracer, mode)(rays)
    names = [e.name for e in _spans(prof)]
    assert names == [f"rtk.tracer.{mode}", FRONT,
                     *(s for s in STEPS if s not in SORTED_ONLY)]


def test_refit_front_end_has_step_spans():
    grid = scenes.deforming_grid(0.0, n=4)
    scene = rt.build_from_soup(grid, device="cpu")
    packed = rt.Tracer(scene).packed
    rays = scenes.camera_rays((0, 3, 4), (0, 0, 0), (0, 1, 0), 50, 8, 8,
                              device="cpu")
    moved = torch.as_tensor(np.asarray(scenes.deforming_grid(0.3, n=4)))
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        pt.trace_packets_refit(packed, scene, moved, rays, sort_rays=True)
    names = [e.name for e in _spans(prof)]
    assert names == [*REFIT, *STEPS]


def _grid_frames(wide=True):
    """A deforming grid's scene (leaf 8), its Tracer with packed tables,
    and two later frames."""
    scene = rt.build_from_soup(
        scenes.deforming_grid(0.0, n=4), device="cpu",
        config=rt.BuildConfig(leaf_size=8, wide_nodes=wide))
    tracer = rt.Tracer(scene)
    tracer.packed
    return scene, tracer, [torch.as_tensor(scenes.deforming_grid(t, n=4))
                           for t in (0.3, 0.6)]


@pytest.mark.parametrize("wide", [True, False])
def test_refit_and_refresh_spans(wide):
    scene, tracer, frames = _grid_frames(wide)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for frame in frames:
            scene = rt.refit(scene, frame)
            tracer = tracer.refresh(scene)
    spans = _spans(prof)
    assert [e.name for e in spans] == [*REFIT, *REFIT]
    # Neither holds the other: the refit ends before the repack starts.
    assert all(e.cpu_parent is None for e in spans)
    for a, b in zip(spans, spans[1:]):
        assert a.time_range.end <= b.time_range.start


def test_refit_packed_binary_span():
    tris = scenes.deforming_grid(0.0, n=4)
    packed, aux = rt.build_sah_packed(
        (tris.reshape(-1, 3), np.arange(tris.shape[0] * 3).reshape(-1, 3)),
        rt.BuildConfig(leaf_size=8), refittable=True, device="cpu")
    rays = _rays(8)
    moved = torch.as_tensor(scenes.deforming_grid(0.3, n=4))
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        pt.trace_packets_refit(packed, aux, moved, rays)
    names = [e.name for e in _spans(prof)]
    assert names == ["rtk.refit", *(s for s in STEPS
                                    if s not in SORTED_ONLY)]


def test_no_refit_span_without_profiler(monkeypatch):
    def refuse(name):
        raise AssertionError(f"a profiler range {name!r} with no profiler")

    scene, tracer, frames = _grid_frames(wide=False)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    scene = rt.refit(scene, frames[0])
    tracer = tracer.refresh(scene)
    pt.trace_packets_refit(tracer.packed, scene, frames[1], _rays(8))
    assert bool(tracer.closest(_rays(8)).hit.any())


@pytest.mark.parametrize("engine", ["stack", "stackless"])
def test_other_engines_have_the_root_span(tracer, engine):
    other = rt.Tracer(tracer.scene, engine=engine)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        other.closest(_rays(8))
    assert [e.name for e in _spans(prof)] == [ROOT]


INSTANCED = ("rtk.instanced.trace", "rtk.instanced.candidates",
             "rtk.instanced.round", "rtk.instanced.residual")
# What a launched round holds, in order; an empty round holds the first.
ROUND = ("rtk.instanced.live", "rtk.instanced.rays", FRONT,
         "rtk.instanced.scatter")
INSTANCED_COUNTERS = ("INSTANCED_TRACES", "INSTANCED_ROUNDS",
                      "INSTANCED_ROWS", "INSTANCED_SYNCS",
                      "INSTANCED_RESIDUAL")


def _count_traces(monkeypatch):
    """Zero the instanced counters and wrap trace_closest_instanced_packets
    so that each trace keeps its stats, beside the rounds its residual
    launched on the stack engine (counted by a wrap of the engine's loop,
    which only the residual runs here) -> the list of (stats, residual
    rounds), one entry a trace."""
    traces, loops = [], []
    real = instancing.trace_closest_instanced_packets
    real_loop = instancing._stack._trace_loop

    def counted(*a, **kw):
        st, before = {}, len(loops)
        out = real(*a, stats=st, **kw)
        traces.append((st, len(loops) - before))
        return out

    def loop(*a, **kw):
        loops.append(1)
        return real_loop(*a, **kw)

    monkeypatch.setattr(instancing, "trace_closest_instanced_packets",
                        counted)
    monkeypatch.setattr(instancing._stack, "_trace_loop", loop)
    for c in INSTANCED_COUNTERS:
        monkeypatch.setattr(instancing, c, 0)
    return traces


def _sync_tally(st, residual_rounds, n, n_inst, auto=False):
    """The host syncs of one instanced trace on the plain route (CPU
    tensors, or plain=True: the rounds' eager glue; on the card the scatter
    is a launch of csrc/rounds.cu with no sync, so a launched round there
    syncs only for its live count) as its stats give them: one a round
    for its live count and six more a launched round (its scatter's
    boolean masks), six more a round its cap cut (bincount's two reads,
    three masks and the copy of True for the index-put), one for auto
    caps' tolist; the residual's count, and where it re-traces rays, a
    live count and six masks a residual round it launched, and the live
    count of the empty round that ended it (none where every instance was
    a round)."""
    m, _ = instancing._grouped_size(n, n_inst, pt.PKT, pt.DEFAULT_P)
    caps = st["caps"] or (m,) * len(st["live_counts"])
    launched = [cap for k, cap in zip(st["live_counts"], caps) if k]
    syncs = (len(st["live_counts"]) + 6 * len(launched)
             + 6 * sum(cap < m for cap in launched) + int(auto) + 1)
    if st["residual"]:
        syncs += 7 * residual_rounds + int(residual_rounds < n_inst)
    return syncs


def _held(spans, rounds):
    """The names of the spans each round holds, in the order they start;
    each ends before the next starts."""
    held = {id(e): [] for e in rounds}
    for e in spans:
        if e.cpu_parent is not None and id(e.cpu_parent) in held:
            held[id(e.cpu_parent)].append(e)
    for inner in held.values():
        inner.sort(key=lambda x: x.time_range.start)
        for a, b in zip(inner, inner[1:]):
            assert a.time_range.end <= b.time_range.start
    return {k: tuple(x.name for x in v) for k, v in held.items()}


def test_instanced_frame_spans_and_counters(monkeypatch):
    """One render_path frame over an InstancedTracer (2 bounces, 3
    traces): each rtk.path.trace holds one rtk.instanced.trace, which
    holds its slab, its C rounds and its residual (the residual's own
    all-instance slab inside it); a round that launches holds its live
    count, its object rays, the rooted trace's rtk.packet_trace and its
    scatter, in that order, and an empty round its live count alone.  The
    counters equal what the traces report: rounds launched, their rows,
    the rays re-traced, and the host syncs of instancing.py's own."""
    from test_torch_instanced_path import BOUNCES, _render, instanced_case

    case = instanced_case()
    traced = _count_traces(monkeypatch)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _render(case)
    spans = [e for e in _spans(prof) if e.name.startswith("rtk.instanced")
             or e.name in ("rtk.path.trace", FRONT)]
    traces = BOUNCES + 1
    c = case["tracer"].max_candidates
    by = {}
    for e in spans:
        by.setdefault(e.name, []).append(e)
    assert len(by["rtk.path.trace"]) == len(by[INSTANCED[0]]) == traces
    assert all(e.cpu_parent.name == "rtk.path.trace"
               for e in by[INSTANCED[0]])
    assert len(by["rtk.instanced.round"]) == c * traces
    assert len(by["rtk.instanced.residual"]) == traces
    for e in by["rtk.instanced.round"] + by["rtk.instanced.residual"]:
        assert e.cpu_parent.name == INSTANCED[0]
    inside = [e.cpu_parent.name for e in by["rtk.instanced.candidates"]]
    assert inside.count(INSTANCED[0]) == traces
    assert set(inside) <= {INSTANCED[0], "rtk.instanced.residual"}
    launched = [e for e in by[FRONT]
                if e.cpu_parent.name == "rtk.instanced.round"]
    assert all(e.cpu_parent.name == "rtk.instanced.round" for e in by[FRONT])
    held = _held(spans, by["rtk.instanced.round"])
    assert set(held.values()) <= {ROUND, ROUND[:1]}
    assert [*held.values()].count(ROUND) == len(launched)
    for stage in set(ROUND) - {FRONT}:
        assert all(e.cpu_parent.name == "rtk.instanced.round"
                   for e in by[stage])

    assert len(traced) == traces
    rows = sum(sum(st["live_counts"]) for st, _ in traced)
    rounds = sum(sum(n > 0 for n in st["live_counts"]) for st, _ in traced)
    residual = sum(st["residual"] for st, _ in traced)
    assert rounds == len(launched) and residual > 0
    got = {n: getattr(instancing, n) for n in INSTANCED_COUNTERS}
    assert got["INSTANCED_TRACES"] == traces
    assert got["INSTANCED_ROUNDS"] == rounds
    assert got["INSTANCED_ROWS"] == rows
    assert got["INSTANCED_RESIDUAL"] == residual
    n_inst = case["pscene"].iscene.num_instances
    assert sum(k > 0 for _, k in traced) > 0
    assert got["INSTANCED_SYNCS"] == sum(
        _sync_tally(st, k, case["rays"].count, n_inst) for st, k in traced)


@pytest.mark.parametrize("caps", ["auto", "starved"])
def test_instanced_syncs_with_round_caps(monkeypatch, caps):
    """INSTANCED_SYNCS of a trace with round caps: the auto caps' tolist,
    and in each round a cap cuts, bincount's reads, the three masks of
    the cut and True copied for its index-put, beside the uncapped
    trace's syncs."""
    from test_torch_instanced_path import instanced_case

    case = instanced_case()
    ps, rays = case["pscene"], case["rays"]
    c = case["tracer"].max_candidates
    traced = _count_traces(monkeypatch)
    want = instancing.trace_closest_instanced_packets(ps, rays, c)
    got = instancing.trace_closest_instanced_packets(
        ps, rays, c, round_caps=caps if caps == "auto" else (128,) * c)
    assert torch.equal(got[0].t, want[0].t)
    assert torch.equal(got[1], want[1])
    n_inst = ps.iscene.num_instances
    auto = caps == "auto"
    tallies = [_sync_tally(st, k, rays.count, n_inst, auto=auto and i == 1)
               for i, (st, k) in enumerate(traced)]
    assert instancing.INSTANCED_SYNCS == sum(tallies)
    if caps == "starved":
        assert tallies[1] > tallies[0] and traced[1][0]["residual"] > 0


def test_instanced_spans_no_profiler_range(monkeypatch):
    """The round's stages draw no profiler range while nothing records,
    and the frame equals the traced one."""
    from test_torch_instanced_path import _render, instanced_case

    case = instanced_case()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        want = _render(case)
    assert {e.name for e in _spans(prof)} >= set(ROUND)

    def refuse(name):
        raise AssertionError(f"a profiler range {name!r} with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    assert not torch.autograd._profiler_enabled()
    assert torch.equal(_render(case), want)


def test_empty_rounds_hold_their_live_count(monkeypatch):
    """Rays that meet no instance box: every round finds no live ray and
    holds only rtk.instanced.live, and the trace syncs once a round and
    once for its residual."""
    from test_torch_instanced_path import instanced_case

    case = instanced_case()
    ps, rays = case["pscene"], case["rays"]
    away = rt.Rays(rays.origin, -rays.direction, rays.min_t, rays.max_t)
    traced = _count_traces(monkeypatch)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        hits, _ = instancing.trace_closest_instanced_packets(ps, away, 2)
    assert not bool(hits.hit.any())
    spans = _spans(prof)
    rounds = [e for e in spans if e.name == "rtk.instanced.round"]
    assert len(rounds) == 2
    held = _held(spans, rounds)
    assert set(held.values()) == {ROUND[:1]}
    ((st, k),) = traced
    assert st["live_counts"] == [0, 0] and st["residual"] == 0
    assert instancing.INSTANCED_SYNCS == _sync_tally(
        st, k, rays.count, ps.iscene.num_instances) == 3

"""render_path with the bounce randomness handed in (models/path.py,
`uniforms`) on a small lit hall of four material ranges, against the plain
path tracer (testing/path_reference.py): the same uniforms by ray and
bounce give the same radiance with compaction, buckets and the sort on or
off, and within the reference's tolerance of its own paths."""
import numpy as np
import pytest
import torch

import rtk_tpu_torch as rt
from rtk_tpu_torch.models import path as tpath
from rtk_tpu_torch.testing import path_reference, scenes

torch.set_num_threads(2)

BOUNCES = 4
BACKGROUND = (0.2, 0.3, 0.4)
# Floor, ceiling (the light: albedo 0 ends a path that reaches it),
# columns, walls; every other albedo keeps a 4-bounce path above the
# throughput floor, so no path ends on it with radiance left to add.
ALBEDO = [[0.7, 0.7, 0.7], [0.0, 0.0, 0.0], [0.6, 0.3, 0.3],
          [0.7, 0.7, 0.7]]
EMISSION = [[0, 0, 0], [4.0, 4.0, 4.0], [0, 0, 0], [0, 0, 0]]
SIDE = 32
TOL = 1e-4  # a path agrees within TOL * max(1, |L_ref|) in each channel


def _hall():
    """Four soups (T, 3, 3): a bumpy floor, a ceiling, four columns and
    two walls (the other two sides open, so paths escape)."""
    vf, ff = scenes.grid_mesh(8, 8, lambda x, z: 0.05 * np.sin(3 * x) *
                              np.cos(2 * z), extent=2.0)
    vc, fc = scenes.grid_mesh(8, 8, lambda x, z: 3.0 + 0.1 * np.cos(x),
                              extent=2.0)
    sv, sf = scenes.icosphere(1)
    cols = [(sv * np.float32([0.25, 1.5, 0.25])
             + np.float32([x, 1.5, z]))[sf]
            for x in (-1.0, 1.0) for z in (-1.0, 1.0)]
    vw, fw = scenes.grid_mesh(4, 2, None, extent=1.0)
    walls = []
    for sgn in (-1, 1):
        w = vw.copy()
        w[:, 1] = (vw[:, 2] + 1.0) * 1.5
        w[:, 2] = vw[:, 0] * 2.0
        w[:, 0] = sgn * 2.0
        walls.append(w[fw])
    return [vf[ff], vc[fc], np.concatenate(cols), np.concatenate(walls)]


@pytest.fixture(scope="module")
def hall():
    parts = [p.astype(np.float32) for p in _hall()]
    meshes = [(p.reshape(-1, 3), np.arange(3 * len(p)).reshape(-1, 3))
              for p in parts]
    tracer = rt.Tracer(rt.build_scene(meshes, device="cpu"))
    mats = tpath.Materials.make(ALBEDO, EMISSION, device="cpu")
    soup = torch.as_tensor(np.concatenate(parts))
    material = torch.cat([torch.full((len(p),), i)
                          for i, p in enumerate(parts)])
    rays = scenes.camera_rays((0.3, 1.4, 1.8), (0, 1.0, 0), (0, 1, 0), 75,
                              SIDE, SIDE, order="morton", device="cpu")
    g = torch.Generator().manual_seed(20)
    uniforms = torch.rand((BOUNCES, rays.count, 2), generator=g)
    return dict(tracer=tracer, mats=mats, soup=soup, material=material,
                rays=rays, uniforms=uniforms)


@pytest.fixture
def small_buckets(monkeypatch):
    """Buckets from 64 rays in place of 1024, so the 32^2 batch's
    compaction drops rays."""
    real = tpath._round_up_bucket
    monkeypatch.setattr(tpath, "_round_up_bucket",
                        lambda n, minimum: real(n, 64))


def _render(h, **kw):
    return tpath.render_path(h["tracer"], h["rays"], h["mats"],
                             background=BACKGROUND,
                             **{"uniforms": h["uniforms"],
                                "bounces": BOUNCES, **kw})


def _reference(h, uniforms=None, mats=None, background=BACKGROUND):
    r = h["rays"]
    m = mats or h["mats"]
    return path_reference.render(
        h["soup"], h["material"], m.albedo, m.emission, r.origin,
        r.direction, r.min_t, r.max_t,
        h["uniforms"] if uniforms is None else uniforms, bounces=BOUNCES,
        background=background)


@pytest.mark.parametrize("compact", [True, False])
@pytest.mark.parametrize("sort_rays", [True, False])
def test_render_path_uniforms_match_reference(hall, small_buckets, compact,
                                              sort_rays):
    """Every path within TOL of the reference's but a path whose hit lies
    within rounding of an edge (at most 1%), and the mean radiance within
    1e-4 of the reference's."""
    got = _render(hall, compact=compact, sort_rays=sort_rays)
    want = _reference(hall)
    bad = ((got - want).abs() > TOL * want.abs().clamp_min(1.0)).any(dim=1)
    assert float(bad.float().mean()) <= 0.01, int(bad.sum())
    assert abs(float(got.mean() / want.mean()) - 1.0) <= 1e-4
    lit = want.amax(dim=1)
    assert float(lit.max()) > 1.0 and float((lit > 0).float().mean()) > 0.5
    # Paths that escaped through the open sides took the background.
    assert int((want == torch.tensor(BACKGROUND)).all(dim=1).sum()) > 10


def test_render_path_uniforms_bit_equal_across_settings(hall, small_buckets):
    """The same uniforms by ray and bounce: one radiance, bit for bit, with
    compaction (buckets that drop dead rays) and the sort on or off."""
    rows = []

    class Counting(rt.Tracer):
        def closest(self, rays, **kw):
            rows.append(rays.count)
            return hall["tracer"].closest(rays, **kw)

    counting = Counting(hall["tracer"].scene)
    got = {}
    for compact in (True, False):
        for sort_rays in (True, False):
            rows.clear()
            got[compact, sort_rays] = tpath.render_path(
                counting, hall["rays"], hall["mats"], bounces=BOUNCES,
                background=BACKGROUND, uniforms=hall["uniforms"],
                compact=compact, sort_rays=sort_rays)
            if compact:  # the buckets shrank
                assert rows[-1] < rows[0] == SIDE * SIDE, rows
    first = got[True, True]
    assert float(first.amax()) > 1.0
    for key, rad in got.items():
        assert torch.equal(rad, first), key


@pytest.mark.parametrize("bad", ["bounces", "rays", "pair", "flat",
                                 "float64"])
def test_render_path_uniforms_wrong_shape_raises(hall, bad):
    u = hall["uniforms"]
    wrong = {"bounces": u[:BOUNCES - 1], "rays": u[:, :-1],
             "pair": torch.cat([u, u[..., :1]], dim=2),
             "flat": u.reshape(-1), "float64": u.double()}[bad]
    with pytest.raises(ValueError, match="uniforms"):
        _render(hall, uniforms=wrong)


def test_render_path_extra_uniform_rows_unused(hall):
    more = torch.cat([hall["uniforms"], torch.rand(2, SIDE * SIDE, 2)])
    assert torch.equal(_render(hall, uniforms=more), _render(hall))


def test_render_path_generator_unchanged(hall):
    """uniforms=None draws from the generator as before: one (2, N) draw a
    bounce batch, which without compaction is the slot of ray i itself,
    so the same draws handed in by ray give the same radiance bit for
    bit; and the default draws the same as uniforms=None given."""
    kw = dict(bounces=BOUNCES, background=BACKGROUND, compact=False)
    h = hall
    a = tpath.render_path(h["tracer"], h["rays"], h["mats"],
                          torch.Generator().manual_seed(5), **kw)
    g = torch.Generator().manual_seed(5)
    drawn = torch.stack([torch.rand((2, h["rays"].count), generator=g).T
                         for _ in range(BOUNCES)])
    b = tpath.render_path(h["tracer"], h["rays"], h["mats"], uniforms=drawn,
                          **kw)
    c = tpath.render_path(h["tracer"], h["rays"], h["mats"],
                          torch.Generator().manual_seed(5), uniforms=None,
                          **kw)
    assert torch.equal(a, b) and torch.equal(a, c)
    # With compaction the generator draws a slot of the compacted batch,
    # so its radiance is another sample of the same image.
    d = tpath.render_path(h["tracer"], h["rays"], h["mats"],
                          torch.Generator().manual_seed(5),
                          **{**kw, "compact": True})
    assert not torch.equal(a, d)
    assert abs(float(d.mean() / a.mean()) - 1.0) < 0.2


def test_reference_furnace_identity(hall):
    """Albedo 1, emission e and background e: each bounce a path is traced
    adds exactly e, and a path goes on exactly while it hits, so radiance
    / e is a whole number in [1, bounces + 1], equal in every channel and
    to render_path's but for a path that grazes an edge."""
    e = 0.5
    furnace = tpath.Materials.make(np.ones((4, 3)), np.full((4, 3), e),
                                   device="cpu")
    q = _reference(hall, mats=furnace, background=(e,) * 3) / e
    assert torch.equal(q, q.round())
    assert torch.equal(q[:, 0], q[:, 1]) and torch.equal(q[:, 0], q[:, 2])
    assert int(q.min()) == 1 and int(q.max()) == BOUNCES + 1
    got = tpath.render_path(hall["tracer"], hall["rays"], furnace,
                            bounces=BOUNCES, background=(e,) * 3,
                            uniforms=hall["uniforms"]) / e
    assert float((got == q).all(dim=1).float().mean()) >= 0.99


def test_reference_takes_uniforms_by_path(hall):
    """Permuting the paths permutes the reference's radiance."""
    perm = torch.randperm(SIDE * SIDE, generator=torch.Generator()
                          .manual_seed(1))
    r = hall["rays"]
    m = hall["mats"]
    got = path_reference.render(
        hall["soup"], hall["material"], m.albedo, m.emission,
        r.origin[perm], r.direction[perm], r.min_t[perm], r.max_t[perm],
        hall["uniforms"][:, perm], bounces=BOUNCES, background=BACKGROUND)
    assert torch.equal(got, _reference(hall)[perm])


# ---- spans and counters (tests/test_torch_spans.py's way) ----

def _path_spans(prof):
    return [e for e in prof.events()
            if e.name.startswith(("rtk.path.", "rtk.tracer."))]


def test_render_path_spans(hall, small_buckets):
    """Under a profiler: one rtk.path.render, and inside it a trace and a
    shade a bounce and a compact a compacted bounce, in the loop's order;
    each trace holds the Tracer's own root span."""
    bounces = 2  # the profiler records every op of the plain traversal
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _render(hall, bounces=bounces)
    spans = _path_spans(prof)
    loop = ["rtk.path.trace", "rtk.path.shade", "rtk.path.compact"]
    want = ["rtk.path.render"] + loop * bounces + loop[:2]
    assert [e.name for e in spans if e.name.startswith("rtk.path.")] == want
    starts = [e.time_range.start for e in spans]
    assert starts == sorted(starts)
    for e in spans:
        parent = e.cpu_parent.name if e.cpu_parent else None
        if e.name == "rtk.path.render":
            assert parent is None
        elif e.name == "rtk.tracer.closest":
            assert parent == "rtk.path.trace"
        else:
            assert parent == "rtk.path.render", e.name
    assert sum(e.name == "rtk.tracer.closest" for e in spans) == bounces + 1
    assert sum(e.name == "rtk.path.compact" for e in spans) == bounces


def test_render_path_no_profiler_no_range(hall, monkeypatch):
    def refuse(name):
        raise AssertionError(f"a profiler range {name!r} with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    assert float(_render(hall).amax()) > 1.0


@pytest.mark.parametrize("compact", [True, False])
def test_render_path_counters(hall, small_buckets, monkeypatch, compact):
    """PATH_TRACES counts the traces, PATH_ROWS the rows they launched
    (counted here by a tracer that wraps the real one) and PATH_SYNCS the
    live counts read on the host: one a compacted bounce, none without
    compaction."""
    rows = []

    class Counting(rt.Tracer):
        def closest(self, rays, **kw):
            rows.append(rays.count)
            return hall["tracer"].closest(rays, **kw)

    for name in ("PATH_TRACES", "PATH_ROWS", "PATH_SYNCS"):
        monkeypatch.setattr(tpath, name, 0)
    tpath.render_path(Counting(hall["tracer"].scene), hall["rays"],
                      hall["mats"], bounces=BOUNCES, background=BACKGROUND,
                      uniforms=hall["uniforms"], compact=compact)
    assert tpath.PATH_TRACES == len(rows) == BOUNCES + 1
    assert tpath.PATH_ROWS == sum(rows)
    assert tpath.PATH_SYNCS == (BOUNCES if compact else 0)
    if compact:
        assert sum(rows) < (BOUNCES + 1) * SIDE * SIDE
    else:
        assert rows == [SIDE * SIDE] * (BOUNCES + 1)


def test_reference_imports_only_torch():
    """The plain path tracer takes nothing from the port: no engine, no
    kernel, no JAX."""
    import ast
    import inspect

    tree = ast.parse(inspect.getsource(path_reference))
    names = {a.name.split(".")[0] for n in ast.walk(tree)
             if isinstance(n, ast.Import) for a in n.names}
    names |= {n.module.split(".")[0] for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom)}
    assert names == {"__future__", "math", "torch"}

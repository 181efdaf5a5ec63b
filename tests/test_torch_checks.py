"""The port's debug validation paths (testing/checks.py) where
tests/test_checks.py says rtk_tpu's raise, and the port-side examples at a
tiny size on the CPU."""
import dataclasses
import importlib.util
import os

import numpy as np
import pytest
import torch

import rtk_tpu_torch as rt
from rtk_tpu_torch.testing import scenes
from rtk_tpu_torch.testing.checks import (ValidationError, checkify_trace,
                                          validate_rays, validate_scene)

from test_torch_trace import CPU, _soup_of

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _good():
    return rt.Rays.make(np.zeros((4, 3), np.float32),
                        np.ones((4, 3), np.float32), device=CPU)


def _with(rays, field, row, value):
    t = getattr(rays, field).clone()
    t[row] = value
    return dataclasses.replace(rays, **{field: t})


@pytest.mark.parametrize("field,row,value,match", [
    ("origin", (1, 0), np.nan, "origin"),
    ("origin", (0, 2), np.inf, "origin"),
    ("direction", (3, 1), np.nan, "direction"),
    ("direction", 2, 0.0, "all-zero"),
    ("min_t", 0, np.nan, "t-window"),
    ("max_t", 3, np.nan, "t-window"),
])
def test_validate_rays_catches(field, row, value, match):
    validate_rays(_good())
    with pytest.raises(ValidationError, match=match):
        validate_rays(_with(_good(), field, row, value))


def test_validate_rays_allows_infinite_windows():
    validate_rays(_with(_with(_good(), "max_t", 0, np.inf), "min_t", 1,
                        -np.inf))


@pytest.fixture(scope="module")
def cornell():
    return rt.build_scene(_soup_of(scenes.cornell_box()), device=CPU)


def test_validate_scene_passes_on_built_scene(cornell):
    validate_scene(cornell)
    validate_scene(rt.build_scene(_soup_of(scenes.blob(2)[0]),
                                  rt.BuildConfig(branching=4), device=CPU))


@pytest.mark.parametrize("field,edit,match", [
    ("node_child", lambda t: t.masked_fill(t >= 0, t.numel() + 7),
     "node table"),
    ("node_child", lambda t: t.masked_fill(t <= -2, -1000), "leaf table"),
    ("bounds_min", lambda t: t * float("nan"), "bounds_min"),
    ("bounds_max", lambda t: t + float("inf"), "bounds_max"),
    ("tri_v", lambda t: t.index_fill(0, torch.tensor([0]), float("nan")),
     "vertices"),
    ("tri_vidx", lambda t: t.index_fill(0, torch.tensor([1]), -1),
     "negative vertex"),
])
def test_validate_scene_catches(cornell, field, edit, match):
    bad = dataclasses.replace(cornell, **{field: edit(getattr(cornell,
                                                              field))})
    if field == "node_child":
        assert not torch.equal(bad.node_child, cornell.node_child)
    with pytest.raises(ValidationError, match=match):
        validate_scene(bad)


def test_checkify_trace_surfaces_nan():
    wrapped = checkify_trace(torch.log)  # NaN for negative input
    err, out = wrapped(torch.tensor([-1.0]))
    assert torch.isnan(out).all() and "NaN" in err.get()
    with pytest.raises(ValidationError, match="NaN"):
        err.throw()
    err, out = wrapped(torch.tensor([2.0]))
    assert err.get() is None
    err.throw()


def test_checkify_trace_walks_hit_records(cornell):
    """A real trace passes (a miss's t is the finite sentinel); an
    infinite max_t carried into a miss's t, or a NaN planted in a nested
    record, is named by its path."""
    tracer = rt.Tracer(cornell)
    rays = scenes.cornell_camera(8, 8, device=CPU)
    err, hits = checkify_trace(tracer.closest)(rays)
    err.throw()
    assert hits.hit.all()
    away = dataclasses.replace(rays, direction=-rays.direction,
                               max_t=torch.full_like(rays.max_t,
                                                     float("inf")))
    err, hits = checkify_trace(tracer.closest)(away)
    assert not hits.hit.any() and "Inf in out.t" in err.get()

    def planted(r):
        h = tracer.closest(r).full()
        return {"hits": (h, dataclasses.replace(h, u=h.u * float("nan")))}

    err, _ = checkify_trace(planted)(rays)
    with pytest.raises(ValidationError, match=r"out\['hits'\]\[1\]\.u"):
        err.throw()


def _example(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_example_render_cornell(tmp_path):
    out = tmp_path / "cornell.ppm"
    rgb = _example("torch_render_cornell").main(str(out), size=16, spp=1,
                                                device=CPU)
    assert out.read_bytes().startswith(b"P6\n16 16\n255\n")
    assert out.stat().st_size == len(b"P6\n16 16\n255\n") + 16 * 16 * 3
    assert np.isfinite(rgb).all() and 0.05 < rgb.mean() < 0.95


def test_example_animate_deform():
    rates = _example("torch_animate_deform").main(frames=2, size=16, grid=8,
                                                  device=CPU)
    assert len(rates) == 2 and all(0.2 < r < 0.9 for r in rates)


def test_example_port_from_rtk(capsys):
    t, t2 = _example("torch_port_from_rtk").main(threads=2, device=CPU)
    assert abs(t - 2.5) < 1e-6 and t2 >= t  # the back wall, z = 0
    assert "port OK" in capsys.readouterr().out


@pytest.mark.parametrize("name", ["torch_render_cornell",
                                  "torch_animate_deform",
                                  "torch_port_from_rtk"])
def test_examples_default_to_the_card(name):
    import inspect

    main = _example(name).main
    assert inspect.signature(main).parameters["device"].default == "cuda"

"""Morton codes and the ray coherence key against rtk_tpu's, value for
value (tolerance 0: integer keys), their int32 carriage, and the
parameter order of the trace front-ends that both packages have."""
import inspect

import numpy as np
import pytest
import torch

import rtk_tpu_torch
from rtk_tpu.ops import morton as jax_morton
from rtk_tpu.ops import pallas_trace as jax_trace
from rtk_tpu.testing import grid as jax_grid
from rtk_tpu.testing import scenes as jax_scenes
from rtk_tpu_torch.ops import morton, packet_trace
from rtk_tpu_torch.testing import grid as torch_grid
from rtk_tpu_torch.testing import scenes

torch.set_num_threads(2)


def _batch(name):
    if name in ("morton", "raster"):  # shared origin: a 64x64 camera
        r = jax_scenes.camera_rays((0, 0, 3), (0, 0, 0), (0, 1, 0), 45, 64,
                                   64, order=name)
        return np.array(r.origin), np.array(r.direction)
    rng = np.random.default_rng(3)  # scattered origins: a bounce batch
    return ((rng.normal(size=(20000, 3)) * 3.0).astype(np.float32),
            rng.normal(size=(20000, 3)).astype(np.float32))


@pytest.mark.parametrize("name", ["morton", "raster", "scattered"])
def test_ray_coherence_key_matches_rtk_tpu(name):
    o, d = _batch(name)
    want = np.asarray(jax_morton.ray_coherence_key(o, d))
    got = morton.ray_coherence_key(torch.from_numpy(o), torch.from_numpy(d))
    assert want.dtype == np.uint32 and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy().astype(np.int64),
                                  want.astype(np.int64))
    # The stable argsort, which is what the trace front-ends use.
    np.testing.assert_array_equal(
        torch.sort(got, stable=True).indices.numpy(),
        np.argsort(want, kind="stable"))


@pytest.mark.parametrize("bits", [10, 7, 1])
def test_codes_are_int32_and_equal(bits):
    rng = np.random.default_rng(bits)
    pts = rng.normal(size=(5000, 3)).astype(np.float32)
    lo, hi = pts.min(0), pts.max(0)
    got = morton.morton3d(torch.from_numpy(pts), torch.from_numpy(lo),
                          torch.from_numpy(hi), bits=bits)
    want = np.asarray(jax_morton.morton3d(pts, lo, hi, bits=bits))
    assert got.dtype == torch.int32 and int(got.min()) >= 0
    np.testing.assert_array_equal(got.numpy().astype(np.int64),
                                  want.astype(np.int64))
    v = torch.arange(1024)
    e = morton.expand_bits10(v)
    assert e.dtype == torch.int32
    np.testing.assert_array_equal(
        e.numpy().astype(np.int64),
        np.asarray(jax_morton.expand_bits10(np.arange(1024))).astype(np.int64))


def test_custom_keys_keep_all_32_bits():
    """build_from_soup(codes=) takes keys past 2^31 (the grid's cell
    prefixes) beside the int32 Morton codes: they sort as unsigned."""
    tris = scenes.deforming_grid(0.0, n=4)
    t = tris.shape[0]
    codes = (np.arange(t, dtype=np.int64)[::-1] * ((1 << 32) // t))
    assert codes.max() >= 1 << 31
    scene = rtk_tpu_torch.build_from_soup(tris, codes=codes, device="cpu")
    np.testing.assert_array_equal(scene.perm.numpy()[:t],
                                  np.arange(t)[::-1])
    with pytest.raises(ValueError, match="2\\^32"):
        rtk_tpu_torch.build_from_soup(tris, codes=codes * 2, device="cpu")


FRONT_ENDS = ["trace_packets", "trace_packets_refit",
              "trace_packets_refit_frames", "trace_packets_chunked"]


@pytest.mark.parametrize("name", FRONT_ENDS)
def test_front_end_parameter_order(name):
    """Every parameter name that both packages' front-ends have comes in
    the same order, and positionally at the same place as far as the two
    lists run together, so a positional call means the same in both."""
    want = inspect.signature(getattr(jax_trace, name)).parameters
    got = inspect.signature(getattr(packet_trace, name)).parameters
    shared = [p for p in want if p in got]
    assert [p for p in got if p in want] == shared
    assert len(shared) >= 3
    positional = (inspect.Parameter.POSITIONAL_ONLY,
                  inspect.Parameter.POSITIONAL_OR_KEYWORD)
    for w, g in zip(want.values(), got.values()):
        if g.kind not in positional:
            break
        assert w.name == g.name, f"position of {g.name}: reference {w.name}"
    # Names that only this package has cannot be passed by position.
    for p in got.values():
        if p.name not in want and p.kind != inspect.Parameter.VAR_KEYWORD:
            assert p.kind == inspect.Parameter.KEYWORD_ONLY, p.name


def test_march_front_end_parameter_order():
    want = inspect.signature(jax_grid.trace_packets_march).parameters
    got = inspect.signature(torch_grid.trace_packets_march).parameters
    shared = [p for p in want if p in got]
    assert [p for p in got if p in want] == shared and len(shared) >= 3

"""camera_rays(on_device=True) against the host path and against
rtk_tpu's camera_rays(device=True), the counterpart of
tests/test_device_camera.py at its bar: the Morton layout exactly (square
power-of-two grids: the closed-form deinterleave is the host's argsort),
directions within 2e-7 (float evaluation order), origins, min_t and
max_t equal, and a Morton grid that is not a square power of two
refused.  Every chip_smoke.py phase makes its cameras this way."""
import numpy as np
import pytest
import torch

from rtk_tpu.testing import scenes as jax_scenes
from rtk_tpu_torch.testing import scenes

CPU = "cpu"
DIR_TOL = 2e-7  # tests/test_device_camera.py's atol


def _check(got, host, ref):
    for want in (host, ref):
        np.testing.assert_allclose(got.direction.numpy(),
                                   np.asarray(want.direction), atol=DIR_TOL)
        for f in ("origin", "min_t", "max_t"):
            np.testing.assert_array_equal(getattr(got, f).numpy(),
                                          np.asarray(getattr(want, f)))


@pytest.mark.parametrize("side", [8, 64])
def test_device_camera_matches_host_morton(side):
    cam = ((0, 0, 3), (0, 0, 0), (0, 1, 0), 45, side, side)
    got = scenes.camera_rays(*cam, order="morton", device=CPU,
                             on_device=True)
    host = scenes.camera_rays(*cam, order="morton", device=CPU)
    ref = jax_scenes.camera_rays(*cam, order="morton", device=True)
    assert got.count == side * side
    _check(got, host, ref)
    # The layout is the same permutation: each ray's nearest host
    # direction is the one at its own index.
    g = got.direction.numpy().astype(np.float64)
    h = host.direction.numpy().astype(np.float64)
    assert np.array_equal(np.argmax(g @ h.T, axis=1), np.arange(g.shape[0]))


def test_device_camera_raster_and_guards():
    cam = ((1, 2, 3), (0, 0, 0), (0, 1, 0), 50, 16, 8)
    got = scenes.camera_rays(*cam, device=CPU, on_device=True)
    _check(got, scenes.camera_rays(*cam, device=CPU),
           jax_scenes.camera_rays(*cam, device=True))
    with pytest.raises(ValueError):
        scenes.camera_rays((0, 0, 3), (0, 0, 0), (0, 1, 0), 45, 16, 8,
                           order="morton", device=CPU, on_device=True)
    with pytest.raises(ValueError):
        scenes.camera_rays((0, 0, 3), (0, 0, 0), (0, 1, 0), 45, 12, 12,
                           order="morton", device=CPU, on_device=True)
    with pytest.raises(ValueError):
        scenes.camera_rays(*cam, order="spiral", device=CPU, on_device=True)
    assert torch.equal(got.origin, torch.tensor([[1.0, 2.0, 3.0]])
                       .expand(got.count, 3))

"""The port's on-device LBVH build against rtk_tpu's: Morton codes, sort
permutation, topology, bounds and sorted triangle tables bit-equal."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rtk_tpu
import rtk_tpu_torch
from rtk_tpu.ops.morton import morton3d
from rtk_tpu_torch.scene import centroid_codes
from rtk_tpu_torch.testing import carry, scenes

torch.set_num_threads(2)
CPU = "cpu"  # the builders default to the card; these tests run on the CPU


def _soup(name):
    if name == "cornell":
        return scenes.cornell_box()
    if name == "blob3":
        return scenes.blob(3)[0]
    return np.random.default_rng(5).normal(size=(300, 3, 3)).astype(
        np.float32)


def assert_bits_equal(got: torch.Tensor, want, name):
    """Equal values, dtypes' widths and float bit patterns (NaN == NaN)."""
    want = np.asarray(want)
    got = got.cpu().numpy()
    assert got.shape == want.shape, (name, got.shape, want.shape)
    if want.dtype.kind == "f":
        assert got.dtype == want.dtype == np.float32, name
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.view(np.int32), err_msg=name)
    else:
        np.testing.assert_array_equal(got.astype(np.int64),
                                      want.astype(np.int64), err_msg=name)


@pytest.mark.parametrize("leaf", [1, 4, 8])
@pytest.mark.parametrize("name", ["cornell", "blob3", "random300"])
def test_build_bit_equal(name, leaf):
    tris = np.asarray(_soup(name), np.float32)
    want = rtk_tpu.build_from_soup(
        tris, config=rtk_tpu.BuildConfig(leaf_size=leaf))
    got = rtk_tpu_torch.build_from_soup(
        tris, config=rtk_tpu_torch.BuildConfig(leaf_size=leaf), device=CPU)
    assert (got.num_tris, got.num_leaves, got.leaf_size, got.has_wide) == (
        want.num_tris, want.num_leaves, want.leaf_size, want.has_wide)
    for f in carry.SCENE_ARRAYS:
        assert_bits_equal(getattr(got, f), getattr(want, f), f)

    # Morton codes: the build's own evaluation against rtk_tpu's morton3d
    # on the same f32 centroids and bounds.
    codes, lo, hi = centroid_codes(torch.from_numpy(tris))
    cc = (tris[:, 0] + tris[:, 1] + tris[:, 2]) * np.float32(1.0 / 3.0)
    jcodes = morton3d(jnp.asarray(cc), jnp.asarray(lo.numpy()),
                      jnp.asarray(hi.numpy()))
    np.testing.assert_array_equal(codes.numpy(),
                                  np.asarray(jcodes).astype(np.int64))


def test_build_scene_mesh_metadata_bit_equal():
    """build_scene over two indexed meshes: the custom vidx/mesh/prim path
    of the sort carries the same metadata as rtk_tpu's."""
    v, f = scenes.blob(2)[1:]
    box = scenes.box([-0.2, -0.2, -0.2], [0.2, 0.2, 0.2])
    meshes = [(v, f), (box.reshape(-1, 3), np.arange(36).reshape(-1, 3))]
    want = rtk_tpu.build_scene(meshes)
    got = rtk_tpu_torch.build_scene(meshes, device=CPU)
    for name in carry.SCENE_ARRAYS:
        assert_bits_equal(getattr(got, name), getattr(want, name), name)


def test_single_leaf_scene():
    tri = np.array([[[0, 0, 0], [1, 0, 0], [0, 1, 0]]], np.float32)
    want = rtk_tpu.build_from_soup(tri)
    got = rtk_tpu_torch.build_from_soup(tri, device=CPU)
    assert got.num_leaves == 1 and got.has_wide
    for f in carry.SCENE_ARRAYS:
        assert_bits_equal(getattr(got, f), getattr(want, f), f)


def test_empty_scene_rejected():
    with pytest.raises(ValueError):
        rtk_tpu_torch.build_from_soup(np.zeros((0, 3, 3), np.float32),
                                       device=CPU)

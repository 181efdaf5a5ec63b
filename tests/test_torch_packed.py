"""The port's kernel tables against rtk_tpu's: nodes, meta and tris from
pack_scene and pack_binary_tree bit-equal (NaN padding rows included)."""
import numpy as np
import pytest
import torch

import rtk_tpu
import rtk_tpu_torch
from rtk_tpu.trace import packed as jpacked
from rtk_tpu_torch.testing import carry, scenes
from rtk_tpu_torch.trace import packed as tpacked
from rtk_tpu_torch.utils.native_sah import NativeOracle

torch.set_num_threads(2)
CPU = "cpu"  # the builders default to the card; these tests run on the CPU


def assert_tables_equal(got, want):
    for f in carry.PACKED_ARRAYS:
        g = getattr(got, f).cpu().numpy()
        w = np.asarray(getattr(want, f))
        assert g.shape == w.shape, (f, g.shape, w.shape)
        if w.dtype.kind == "f":
            # Bit patterns: NaN padding rows equal NaN, -0 differs from 0.
            np.testing.assert_array_equal(g.view(np.int32),
                                          w.view(np.int32), err_msg=f)
        else:
            np.testing.assert_array_equal(g.astype(np.int64),
                                          w.astype(np.int64), err_msg=f)
    assert (got.num_tris, got.leaf_size, got.branching) == (
        want.num_tris, want.leaf_size, want.branching)


def _tris(name):
    if name == "cornell":
        return scenes.cornell_box()
    if name == "blob3":
        return scenes.blob(3)[0]
    return np.random.default_rng(5).normal(size=(300, 3, 3)).astype(
        np.float32)


@pytest.mark.parametrize("leaf", [1, 4, 8])
@pytest.mark.parametrize("name", ["cornell", "blob3", "random300"])
def test_pack_scene_bit_equal(name, leaf):
    tris = np.asarray(_tris(name), np.float32)
    jscene = rtk_tpu.build_from_soup(
        tris, config=rtk_tpu.BuildConfig(leaf_size=leaf))
    tscene = rtk_tpu_torch.build_from_soup(
        tris, config=rtk_tpu_torch.BuildConfig(leaf_size=leaf), device=CPU)
    mask = (np.arange(tris.shape[0]) % 3 + 1).astype(np.uint32)
    for tri_mask in (None, mask):
        got = tpacked.pack_scene(tscene, tri_mask=tri_mask)
        assert_tables_equal(got, jpacked.pack_scene(jscene,
                                                    tri_mask=tri_mask))
        # The recorded depth is the BFS level count of the table.
        assert got.depth == tpacked.tree_depth(got.meta.numpy())
        assert got.stack_size == 1 + 7 * got.depth


@pytest.mark.parametrize("leaf,step_quant", [(4, False), (16, True)])
def test_pack_binary_tree_bit_equal(leaf, step_quant):
    """One SAH topology (the shared native/rtk_oracle.cpp, built by the
    port) packs to identical tables in both packages, and
    build_sah_packed is that same pipeline behind the mesh front-end."""
    v, f = scenes.blob(3)[1:]
    soup = rtk_tpu_torch.mesh.build_soup((v, f))
    tris = soup.tri_pos
    tree = NativeOracle(tris, leaf_max=leaf,
                        step_quant=step_quant).export_tree()
    mask = (np.arange(tris.shape[0]) % 5 + 1).astype(np.uint32)
    kw = dict(leaf_size=leaf, tri_vidx=soup.tri_vidx, tri_mesh=soup.tri_mesh,
              tri_prim=soup.tri_prim, tri_mask=mask)
    want = jpacked.pack_binary_tree(tris, *tree, **kw)
    assert_tables_equal(tpacked.pack_binary_tree(tris, *tree, **kw,
                                                 device=CPU), want)
    api = rtk_tpu_torch.build_sah_packed(
        (v, f), rtk_tpu_torch.BuildConfig(leaf_size=leaf),
        tri_mask=mask, step_quant=step_quant, device=CPU)
    assert_tables_equal(api, want)


def test_pack_binary_tree_default_metadata():
    """Without vidx/mesh/prim the table takes rtk_tpu's defaults (padding
    rows included)."""
    tris = np.asarray(scenes.cornell_box(), np.float32)
    tree = NativeOracle(tris, leaf_max=8).export_tree()
    got = tpacked.pack_binary_tree(tris, *tree, leaf_size=8, device=CPU)
    assert_tables_equal(got, jpacked.pack_binary_tree(tris, *tree,
                                                      leaf_size=8))


def test_carried_tables_equal_the_port_pack():
    """testing.carry turns rtk_tpu's tables into the port's, bit for bit
    and with the same depth as the port's own pack."""
    tris = np.asarray(scenes.cornell_box(), np.float32)
    jp = jpacked.pack_scene(rtk_tpu.build_from_soup(tris))
    arrays = {k: np.asarray(getattr(jp, k)) for k in carry.PACKED_ARRAYS}
    got = carry.packed_from_arrays(arrays, num_tris=jp.num_tris,
                                   leaf_size=jp.leaf_size, device=CPU)
    own = tpacked.pack_scene(rtk_tpu_torch.build_from_soup(tris, device=CPU))
    assert_tables_equal(got, jp)
    assert got.depth == own.depth


def test_tree_depth_counts_bfs_levels():
    """A chain of 10 binary nodes, each with one leaf: the greedy 8-wide
    collapse takes 7 of them into the root row, the other 3 into one
    second-level row, so the table has 2 levels (stack 1 + 2*7)."""
    left = np.append(np.arange(1, 10), -2).astype(np.int64)
    right = -np.arange(3, 13).astype(np.int64)
    slot_src = tpacked._greedy_slots(left, right, np.ones(10))
    meta, leaf_order = tpacked._pack_meta(slot_src)
    assert slot_src.shape[0] == 2 and leaf_order.shape[0] == 11
    assert tpacked.tree_depth(meta) == 2

"""Forest tables (several BLAS trees in one packed table) against rtk_tpu's,
and the tree depth that sizes the traversal stack, over every forest
layout: per-root blocks one after another (pack_forest) and R root rows
first (pack_multiroot, the forest form of pack_binary_tree)."""
import numpy as np
import pytest
import torch

import rtk_tpu
from rtk_tpu import instancing as jinst
from rtk_tpu.builder import sah as jsah
from rtk_tpu.trace import packed as jpacked
from rtk_tpu_torch import BuildConfig
from rtk_tpu_torch.builder.sah import build_sah_forest
from rtk_tpu_torch.testing import carry, scenes
from rtk_tpu_torch.trace import packed as tpacked

from test_torch_kernel import chain_forest
from test_torch_packed import assert_tables_equal

torch.set_num_threads(2)
CPU = "cpu"  # the builders default to the card; these tests run on the CPU

STACK_CAP = 256  # entries of the CUDA kernel's compiled stack


def _soup_of(tris):
    return (tris.reshape(-1, 3), np.arange(tris.shape[0] * 3).reshape(-1, 3))


def _brute_depth(meta, row):
    """Levels below and including `row`, by recursion over its children."""
    fc, im = int(meta[row, 0]), int(meta[row, 2]) & 0xFF
    kids = [fc + j for j in range(bin(im).count("1"))]
    return 1 + max((_brute_depth(meta, c) for c in kids), default=0)


def _check_depth(packed, roots):
    """depth and stack_size are the maximum over the roots; the second
    (deeper) tree sets it, so a walk of the first root alone falls short."""
    meta = packed.meta.numpy()
    per_root = [_brute_depth(meta, int(r)) for r in roots]
    assert per_root[1] > per_root[0], per_root
    assert packed.depth == max(per_root)
    assert packed.stack_size == 1 + 7 * max(per_root)
    assert tpacked.tree_depth(meta) == max(per_root)  # roots found alone
    np.testing.assert_array_equal(tpacked.table_roots(meta),
                                  np.sort(np.asarray(roots)))


@pytest.fixture(scope="module")
def forest():
    """cornell_box then blob(3): the second BLAS is the deeper.  rtk_tpu's
    merged Scene, and the same Scene carried into the port."""
    tris = [scenes.cornell_box(), scenes.blob(3)[0]]
    jmerged, roots = jinst.merge_blas(
        [rtk_tpu.build_scene(_soup_of(t)) for t in tris])
    arrays = {k: np.asarray(getattr(jmerged, k)) for k in carry.SCENE_ARRAYS}
    tmerged = carry.scene_from_arrays(
        arrays, num_tris=jmerged.num_tris, leaf_size=jmerged.leaf_size,
        branching=jmerged.branching, num_leaves=jmerged.num_leaves,
        device=CPU)
    return tris, jmerged, tmerged, roots


def test_pack_forest_bit_equal(forest):
    _, jmerged, tmerged, roots = forest
    got, got_roots = tpacked.pack_forest(tmerged, roots)
    want, want_roots = jpacked.pack_forest(jmerged, roots)
    assert_tables_equal(got, want)
    np.testing.assert_array_equal(got_roots, want_roots)
    assert got_roots.dtype == np.int32
    _check_depth(got, got_roots)


@pytest.mark.parametrize("masked", [False, True])
def test_pack_multiroot_bit_equal(forest, masked):
    _, jmerged, tmerged, roots = forest
    mask = (np.arange(tmerged.num_tris) % 3 + 1).astype(np.uint32)
    mask = mask if masked else None
    got = tpacked.pack_multiroot(tmerged, roots, tri_mask=mask)
    assert_tables_equal(got, jpacked.pack_multiroot(jmerged, roots,
                                                    tri_mask=mask))
    _check_depth(got, np.arange(len(roots)))


@pytest.mark.parametrize("leaf", [8, 16])
def test_build_sah_forest_bit_equal(forest, leaf):
    """The forest form of pack_binary_tree, behind build_sah_forest."""
    tris = forest[0]
    got, got_roots = build_sah_forest(tris, BuildConfig(leaf_size=leaf),
                                       device=CPU)
    want, want_roots = jsah.build_sah_forest(
        tris, rtk_tpu.BuildConfig(leaf_size=leaf))
    assert_tables_equal(got, want)
    np.testing.assert_array_equal(got_roots, want_roots)
    _check_depth(got, got_roots)


def test_deep_second_tree_sets_the_stack():
    """A forest whose second tree needs more than the kernel's 256-entry
    stack: stack_size says so (the kernel wrapper refuses it, see
    test_torch_kernel.py), where a walk of the first root alone says 8."""
    tri_v, *tree, roots = chain_forest(280)
    got = tpacked.pack_binary_tree(tri_v, *tree, roots, leaf_size=1,
                                   device=CPU)
    assert_tables_equal(got, jpacked.pack_binary_tree(tri_v, *tree, roots,
                                                      leaf_size=1))
    _check_depth(got, [0, 1])
    assert got.stack_size > STACK_CAP
    assert 1 + 7 * tpacked.tree_depth(got.meta.numpy(), [0]) == 8


def test_carried_forest_keeps_its_depth(forest):
    """testing.carry reads the depth over the given roots, or over every
    root it finds."""
    _, jmerged, tmerged, roots = forest
    jp = jpacked.pack_multiroot(jmerged, roots)
    arrays = {k: np.asarray(getattr(jp, k)) for k in carry.PACKED_ARRAYS}
    own = tpacked.pack_multiroot(tmerged, roots)
    for given in (None, np.arange(len(roots))):
        got = carry.packed_from_arrays(arrays, num_tris=jp.num_tris,
                                       leaf_size=jp.leaf_size, roots=given,
                                       device=CPU)
        assert got.depth == own.depth
    with pytest.raises(ValueError, match="root"):
        tpacked.tree_depth(own.meta.numpy(), [own.num_nodes])

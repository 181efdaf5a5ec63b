"""The roofline's work count: its tree is the stated one, its walk finds
the reference's closest hits, and the count repeats exactly for a seed."""
import numpy as np
import pytest
import torch

from rtbench import harness, reference, workcount
from rtbench.scenes import atrium, blob
from rtbench.traffic import generate
from rtbench.tests import tiny


@pytest.mark.parametrize("leaf,width", [(4, 8), (16, 8), (1, 2), (3, 4)])
def test_tree_holds_every_triangle_once(leaf, width):
    v, f = blob.make(2)
    soup = v[f]
    tree = workcount.build_lbvh(soup, leaf, width)
    assert int(tree.leaf_count.sum()) == len(soup)
    assert (tree.leaf_count <= leaf).all() and (tree.leaf_count > 0).all()
    got = tree.leaf_tris.reshape(-1, 3, 3)[
        (torch.arange(leaf)[None] < tree.leaf_count[:, None]).reshape(-1)]
    key = lambda a: np.sort(a.reshape(len(a), -1), axis=0)  # noqa: E731
    np.testing.assert_array_equal(key(got.numpy()), key(soup))
    # Every child box holds what lies below it.
    ch = tree.child
    leaves = (ch < 0) & (ch != workcount.EMPTY)
    lt = tree.leaf_tris[(-ch[leaves] - 1)]
    cnt = tree.leaf_count[(-ch[leaves] - 1)]
    real = (torch.arange(leaf)[None] < cnt[:, None])[..., None, None]
    lo = torch.where(real, lt, torch.inf).amin(dim=(1, 2))
    hi = torch.where(real, lt, -torch.inf).amax(dim=(1, 2))
    assert torch.equal(lo, tree.cmin[leaves])
    assert torch.equal(hi, tree.cmax[leaves])
    assert (ch != workcount.EMPTY).sum(1).max() <= width


@pytest.mark.parametrize("name", sorted(tiny.TRAFFIC))
def test_walk_finds_the_closest_hits(name):
    v, f = blob.make(3)
    soup = v[f]
    tree = workcount.build_lbvh(soup, 4, 8)
    x = generate.make(tiny.TRAFFIC[name], 9, torch.as_tensor(soup), "cpu")[0]
    ray = [x[k] for k in ("origin", "direction", "min_t", "max_t")]
    boxes, tests, best = workcount.count(tree, *ray)
    hit, t, *_ = reference.closest(torch.as_tensor(soup), *ray)
    assert torch.equal(best, t)
    assert (boxes > 0).all() and (tests[hit] > 0).all()


def test_bound_repeats_for_a_seed():
    v, f = atrium.make(columns=2)
    soup = v[f]
    traffic = tiny.TRAFFIC["tiny-bounce"]
    cell = {"config": {"build": {"leaf_size": 16, "width": 8}}}
    card = "NVIDIA H100 80GB HBM3"

    def bound(seed):
        b = generate.make(traffic, seed, torch.as_tensor(soup), "cpu")
        return harness.work_bound(cell, soup, b, seed, card)

    a, b, c = bound(21), bound(21), bound(22)
    assert a == b and a != c
    assert a["by"] in ("operations", "bytes") and a["ms"] > 0
    assert harness.work_bound(cell, soup, [], 1, "no such card") is None

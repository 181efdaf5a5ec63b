"""The benchmark's frozen scene generators give the program's soups at the
pinned seeds (the program's generators are read here, in the test only;
the harness never imports them)."""
import numpy as np
import pytest

from rtbench.scenes import atrium, blob
from rtk_tpu_torch.testing import scenes


@pytest.mark.parametrize("sub", [2, 6])
def test_blob_is_the_programs(sub):
    v, f = blob.make(subdivisions=sub, seed=0, displace=0.15)
    soup, pv, pf = scenes.blob(sub)
    np.testing.assert_array_equal(v, pv)
    np.testing.assert_array_equal(f, pf)
    np.testing.assert_array_equal(v[f], soup)


def test_blob6_has_81920_triangles():
    v, f = blob.make(subdivisions=6)
    assert f.shape == (81920, 3) and f.dtype == np.int32


def test_atrium_is_the_programs():
    v, f = atrium.make(columns=8, seed=0)
    soup = scenes.atrium()
    assert f.shape == (409_600, 3)
    np.testing.assert_array_equal(v[f], soup)

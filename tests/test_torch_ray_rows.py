"""The rows of the packet front end (ops/packet_trace.py::_ray_rows): the
plain version is the stacking and the gather, CPU tensors and the plain
front end keep that path and its spans and never touch the library, and
the card's order of steps (key, sort, then one rows pass through the
permutation) gives the same rows.  csrc/ray_rows.cu itself is held against
the plain version in tests/test_torch_kernel_host.py (a host build) and
tests/test_torch_kernel.py (the card)."""
import pytest
import torch

from rtk_tpu_torch.ops import morton
from rtk_tpu_torch.ops import packet_trace as pt
from rtk_tpu_torch.testing import scenes
from rtk_tpu_torch.types import Rays

from test_torch_kernel_host import rows_batch, same_bits

torch.set_num_threads(2)

STEPS = "rtk.packet_trace."


def _cat_rows(o, d, mn, mx):
    """The rows as the front end stacked them before the rows pass."""
    return torch.cat([o.T, d.T, mn[None], mx[None]]).to(torch.float32)


def _rays(n, seed):
    return Rays(*rows_batch(n, seed)[0])


def _camera(side=16):
    return scenes.camera_rays((0, 0, 3.0), (0, 0, 0), (0, 1, 0), 45, side,
                              side, device="cpu")


def _spans(prof):
    return [e.name[len(STEPS):] for e in prof.events()
            if e.name.startswith(STEPS)]


@pytest.mark.parametrize("sort", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ray_rows_reference_is_the_cat_and_gather(seed, sort):
    """ray_rows_reference is the stacking, then the gather through idx
    when it is given; f64 rays give the bits of their f32 casts."""
    n = 300 + 97 * seed
    parts, perm = rows_batch(n, seed)
    idx = perm if sort else None
    want = _cat_rows(*parts)
    if sort:
        want = want[:, idx]
    got = pt.ray_rows_reference(*parts, idx)
    assert got.dtype == torch.float32 and got.is_contiguous()
    assert same_bits(got, want)
    wide = rows_batch(n, seed, torch.float64)[0]
    assert same_bits(pt.ray_rows_reference(*wide, idx), got)


@pytest.mark.parametrize("plain", [False, True])
@pytest.mark.parametrize("sort", [False, True])
def test_cpu_ray_rows_keep_the_plain_path(sort, plain):
    """On CPU tensors, and in the plain front end, _ray_rows stacks the
    rows, sorts by the plain key and gathers, as before the rows pass: the
    same rows and index, the spans rows, key, sort, gather (rows alone
    unsorted), and no launch of the library."""
    rays = _rays(777, 3)
    before = (pt.ROWS_LAUNCHES, pt.KEY_LAUNCHES)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        rows, idx = pt._ray_rows(rays, sort, plain=plain)
    assert (pt.ROWS_LAUNCHES, pt.KEY_LAUNCHES) == before
    want = _cat_rows(rays.origin, rays.direction, rays.min_t, rays.max_t)
    if sort:
        want_idx = torch.sort(morton.ray_coherence_key_reference(
            rays.origin, rays.direction), stable=True).indices
        assert torch.equal(idx, want_idx)
        want = want[:, want_idx].contiguous()
    else:
        assert idx is None
    assert same_bits(rows, want)
    assert _spans(prof) == (["rows", "key", "sort", "gather"] if sort
                            else ["rows"])


@pytest.mark.parametrize("sort", [False, True])
def test_card_order_of_the_front_steps(monkeypatch, sort):
    """With the steps of the card (here the plain rows behind another
    callable, as _front_steps hands out the kernels), _ray_rows sorts
    first and writes the rows once through the permutation: the spans key,
    sort, rows (rows alone unsorted), no gather, and the plain path's rows
    and index."""
    rays = _camera()
    want_rows, want_idx = pt._ray_rows(rays, sort)
    calls = []

    def rows_of(*args):
        calls.append(len(args))
        return pt.ray_rows_reference(*args)

    steps = (morton.ray_coherence_key_reference, rows_of, pt.unsort_reference)
    monkeypatch.setattr(pt, "_front_steps", lambda *a: steps)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        rows, idx = pt._ray_rows(rays, sort)
    assert calls == [5]
    assert _spans(prof) == (["key", "sort", "rows"] if sort else ["rows"])
    assert same_bits(rows, want_rows)
    assert (idx is None) == (not sort)
    if sort:
        assert torch.equal(idx, want_idx)

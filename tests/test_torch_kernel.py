"""The CUDA packet-traversal kernel, the sorted front end's kernels (the
coherence key, the rows pass and the unsort) and the dispatch probe of
tools/torch_profile_trace.py, against their plain PyTorch versions on the
card.  Needs a CUDA device and nvcc: each test skips without a card.  On
the H100: `python -m pytest tests/test_torch_kernel.py -m cuda -q`."""
import contextlib
import os
import sys
import warnings

import numpy as np
import pytest
import torch

import rtk_tpu_torch
from rtk_tpu_torch.ops import library, packet_trace
from rtk_tpu_torch.testing import scenes
from rtk_tpu_torch.trace.packed import pack_scene

# The port's profiling tools, imported from their folder (the probe's
# binding lives in one).
TOOLS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "tools")
if TOOLS not in sys.path:
    sys.path.append(TOOLS)
import torch_profile_trace as ptrace  # noqa: E402

pytestmark = pytest.mark.cuda

torch.set_num_threads(2)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _soup_of(tris):
    return (tris.reshape(-1, 3), np.arange(tris.shape[0] * 3).reshape(-1, 3))


def _both(packed, rays, **kw):
    before = packet_trace.KERNEL_LAUNCHES
    got = packet_trace.trace_packets(packed, rays, **kw)
    torch.cuda.synchronize()
    assert packet_trace.KERNEL_LAUNCHES == before + 1
    return got, packet_trace.trace_packets_reference(packed, rays, **kw)


def _assert_same(got, want):
    for f in ("hit", "slot", "t", "u", "v"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f


@pytest.mark.parametrize("leaf", [1, 4, 16])
def test_kernel_matches_reference(cuda, leaf):
    v, f = scenes.blob(4)[1:]
    mask = (np.arange(f.shape[0]) % 3 + 1).astype(np.uint32)
    scene = rtk_tpu_torch.build_scene(
        (v, f), rtk_tpu_torch.BuildConfig(leaf_size=leaf), device=cuda)
    packed = pack_scene(scene, tri_mask=mask)
    rays = scenes.camera_rays((0, 0, 3.0), (0, 0, 0), (0, 1, 0), 45, 96, 96,
                              order="morton", device=cuda)
    for kw in (dict(), dict(mode="any"), dict(filter_mask=2),
               dict(defer_uv=True), dict(sort_rays=True)):
        _assert_same(*_both(packed, rays, **kw))


def test_kernel_random_soup_and_dead_rays(cuda):
    rng = np.random.default_rng(3)
    tris = rng.normal(size=(1280, 3, 3)).astype(np.float32)
    packed = pack_scene(rtk_tpu_torch.build_scene(_soup_of(tris),
                                                  device=cuda))
    n = 4096
    dead = rng.random(n) < 0.3
    rays = rtk_tpu_torch.Rays.make(
        rng.normal(size=(n, 3)) * 3.0, rng.normal(size=(n, 3)), 0.0,
        np.where(dead, 0.0, 3.0e38), device=cuda)
    for mode in ("closest", "any"):
        got, want = _both(packed, rays, mode=mode)
        _assert_same(got, want)
        assert not got.hit[torch.as_tensor(dead, device=cuda)].any()


def test_kernel_sah_tables(cuda):
    tris = scenes.blob(4)[0]
    packed = rtk_tpu_torch.build_sah_packed(
        _soup_of(tris), rtk_tpu_torch.BuildConfig(leaf_size=16),
        step_quant=True, device=cuda)
    rays = scenes.camera_rays((0, 0, 3.0), (0, 0, 0), (0, 1, 0), 45, 64, 64,
                              device=cuda)
    _assert_same(*_both(packed, rays))


def test_kernel_refuses_too_deep_tree(cuda):
    packed = pack_scene(rtk_tpu_torch.build_scene(
        _soup_of(scenes.cornell_box()), device=cuda))
    cap = library.load_kernel().rtk_packet_trace_max_stack()
    rays = torch.zeros((8, 4), device=cuda)
    with pytest.raises(ValueError, match="stack"):
        packet_trace.packet_trace_kernel(
            packed.nodes, packed.tris, rays, leaf_size=packed.leaf_size,
            stack_size=cap + 1)


def chain_forest(chain):
    """Binary arrays (pack_binary_tree's arguments) of a two-tree forest: a
    single leaf (root 2*chain+1), then a chain of `chain` internal nodes,
    each with one leaf (root 0), whose greedy 8-wide collapse is about
    chain/7 levels deep."""
    leaves = chain + 2
    n_nodes = chain + leaves
    left = np.full(n_nodes, -1, np.int64)
    right = np.full(n_nodes, -1, np.int64)
    left[:chain - 1] = np.arange(1, chain)
    left[chain - 1] = chain
    right[:chain] = np.arange(chain + 1, 2 * chain + 1)
    first = np.zeros(n_nodes, np.int64)
    count = np.zeros(n_nodes, np.int64)
    first[chain:] = np.arange(leaves)
    count[chain:] = 1
    lo = np.zeros((n_nodes, 3), np.float32)
    hi = np.ones((n_nodes, 3), np.float32)
    tri_v = np.random.default_rng(3).normal(size=(leaves, 3, 3)).astype(
        np.float32)
    return (tri_v, left, right, first, count, lo, hi, np.arange(leaves),
            np.array([2 * chain + 1, 0]))


def tie_tree(leaves, count, seed=7):
    """Binary arrays (pack_binary_tree's arguments) of a balanced tree
    over `leaves` leaves (a power of two) of `count` triangles each, made
    to tie: every node has the same box, so all children of a wide node
    lie at one entry distance and are ordered by slot alone, and leaf
    2j+1 repeats leaf 2j's triangles, so every hit is found twice at one
    t and the first found must win."""
    rng = np.random.default_rng(seed)
    half = rng.normal(size=(leaves // 2, count, 3, 3)).astype(np.float32)
    tri_v = np.repeat(half, 2, axis=0).reshape(-1, 3, 3)
    n_nodes = 2 * leaves - 1
    node = np.arange(n_nodes)
    inner = node < leaves - 1
    left = np.where(inner, 2 * node + 1, -1)
    right = np.where(inner, 2 * node + 2, -1)
    first = np.where(inner, 0, (node - (leaves - 1)) * count)
    cnt = np.where(inner, 0, count)
    lo = np.tile(tri_v.min(axis=(0, 1)), (n_nodes, 1))
    hi = np.tile(tri_v.max(axis=(0, 1)), (n_nodes, 1))
    return tri_v, left, right, first, cnt, lo, hi, np.arange(len(tri_v)), 0


# (leaf_size, triangles a leaf, table width): whole leaves at the sizes in
# use, and short ones whose NaN padding rows fall in the leaf loop's
# unrolled part and in its remainder.
TIE_CASES = [(1, 1, 8), (4, 4, 8), (8, 7, 8), (16, 16, 8), (6, 5, 16),
             (4, 3, 16)]


def tie_rays(n, device, seed=12):
    """Rays towards the tie_tree's triangles, a fifth with a short t
    window and a tenth dead."""
    rng = np.random.default_rng(seed)
    u = rng.random(n)
    origin = rng.normal(size=(n, 3)) * 4.0
    return rtk_tpu_torch.Rays.make(
        origin, rng.normal(size=(n, 3)) * 0.7 - origin,
        np.where(u < 0.2, 0.5, 0.0),
        np.where(u < 0.1, 0.0, np.where(u < 0.2, 4.0, 3.0e38)),
        device=device)


def grouped_tree(groups, boxes=None):
    """Binary arrays (pack_binary_tree's arguments) of a balanced tree
    whose leaf i holds groups[i], a (c, 3, 3) array of triangles; a node's
    box bounds its triangles, or is boxes[i] = (lo, hi) for leaf i."""
    counts = [len(g) for g in groups]
    offset = np.concatenate([[0], np.cumsum(counts)[:-1]])
    cols = left, right, first, cnt, lo, hi = [], [], [], [], [], []

    def make(a, b):
        i = len(left)
        for c in cols:
            c.append(None)
        if b - a == 1:
            left[i] = right[i] = -1
            first[i], cnt[i] = offset[a], counts[a]
            pts = groups[a].reshape(-1, 3)
            lo[i], hi[i] = (pts.min(0), pts.max(0)) if boxes is None \
                else boxes[a]
        else:
            m = (a + b + 1) // 2
            left[i], right[i] = make(a, m), make(m, b)
            first[i] = cnt[i] = 0
            lo[i] = np.minimum(lo[left[i]], lo[right[i]])
            hi[i] = np.maximum(hi[left[i]], hi[right[i]])
        return i

    make(0, len(groups))
    tri_v = np.concatenate(groups).astype(np.float32)
    return (tri_v, np.array(left), np.array(right), np.array(first),
            np.array(cnt), np.array(lo, np.float32), np.array(hi, np.float32),
            np.arange(len(tri_v)), 0)


# Masks of the mask cases: single bits, two bits, the top bit of the 24
# and all 24.
MASK_QMASKS = (1, 2, 3, 0x800000, 0xFFFFFF)


def mask_tree(leaf_size, seed=5):
    """(binary arrays, tri_mask) of twelve leaves of up to leaf_size
    triangles, made for the mask filter: a leaf whose every row no mask
    passes (bits 0); leaves whose first row passes mask 1 and whose last
    real row fails it, short ones followed by NaN padding up to the next
    leaf's first row; single- and multi-bit masks between.  Triangle 0
    passes every mask, so the padding rows, which take its bits, pass the
    mask too and are rejected as padding."""
    rng = np.random.default_rng(seed)
    k = leaf_size
    counts = [k, k, max(k - 2, 1), k, 1, max(k // 2, 1), k, max(k - 1, 1),
              k, max(k - 3, 1), k, min(2, k)]
    bits = np.array([0, 1, 2, 3, 4, 0x800000, 0xFFFFFF])
    groups, masks = [], []
    for i, c in enumerate(counts):
        groups.append(rng.normal(size=(c, 3, 3)) * 0.4
                      + rng.normal(size=3) * 1.5)
        m = bits[rng.integers(0, len(bits), c)]
        if i == 1:
            m[:] = 0
        else:
            m[-1] = rng.choice([2, 4])
            m[0] = rng.choice([1, 3, 0xFFFFFF])
        masks.append(m)
    masks[0][0] = 0xFFFFFF
    return grouped_tree(groups), np.concatenate(masks).astype(np.uint32)


def _root_slot_boxes(nodes):
    """The (lo, hi) boxes of a 16-wide table's root row by slot."""
    b = nodes[:16, :6].cpu().contiguous().view(torch.float32).numpy()
    return b[:, :3], b[:, 3:]


def wide_tie_tree(n, seed=6):
    """Binary arrays of n <= 16 leaves of three triangles whose 16-wide
    collapse is one root of n leaf children, the children in slots 7 and
    8 given one box: they lie at one entry distance from every ray, a tie
    across the halves of the node's sixteen slots.  The first seed from
    `seed` on whose collapse keeps the two in those slots."""
    from rtk_tpu_torch.trace.packed import pack_binary_tree

    def root_boxes(groups, boxes):
        lo, hi = _root_slot_boxes(pack_binary_tree(
            *grouped_tree(groups, boxes), leaf_size=4, branching=16,
            device="cpu").nodes)
        return lo, hi

    for s in range(seed, seed + 100):
        rng = np.random.default_rng(s)
        groups = [rng.normal(size=(3, 3, 3)) * 0.3 + rng.normal(size=3) * 1.5
                  for _ in range(n)]
        boxes = [(g.reshape(-1, 3).min(0).astype(np.float32),
                  g.reshape(-1, 3).max(0).astype(np.float32))
                 for g in groups]
        lo, _ = root_boxes(groups, boxes)
        a, b = (next(i for i, (l, _) in enumerate(boxes)
                     if np.array_equal(l, lo[j])) for j in (7, 8))
        boxes[a] = boxes[b] = (np.minimum(boxes[a][0], boxes[b][0]),
                               np.maximum(boxes[a][1], boxes[b][1]))
        lo, hi = root_boxes(groups, boxes)
        if np.array_equal(lo[7], lo[8]) and np.array_equal(hi[7], hi[8]):
            return grouped_tree(groups, boxes)
    raise AssertionError(f"no seed ties slots 7 and 8 of {n} children")


def test_kernel_refuses_deep_forest(cuda):
    """The second tree of this forest needs more than the compiled stack;
    the first alone would fit.  The wrapper refuses before launch."""
    from rtk_tpu_torch.trace.packed import pack_binary_tree

    tri_v, *tree, roots = chain_forest(280)
    packed = pack_binary_tree(tri_v, *tree, roots, leaf_size=1, device=cuda)
    cap = library.load_kernel().rtk_packet_trace_max_stack()
    assert packed.stack_size > cap
    rays = scenes.camera_rays((0, 0, 3.0), (0, 0, 0), (0, 1, 0), 45, 8, 8,
                              device=cuda)
    before = packet_trace.KERNEL_LAUNCHES
    with pytest.raises(ValueError, match="stack"):
        packet_trace.trace_packets(packed, rays,
                                   ray_roots=torch.zeros(
                                       64, dtype=torch.int32, device=cuda))
    assert packet_trace.KERNEL_LAUNCHES == before


def _two_blas_forests(device):
    """cornell_box then blob(3), merged, as a pack_forest table and as a
    pack_multiroot table with one EMPTY root row after the two BLAS."""
    from rtk_tpu_torch.instancing import merge_blas
    from rtk_tpu_torch.trace.packed import pack_forest, pack_multiroot

    merged, roots = merge_blas([
        rtk_tpu_torch.build_scene(_soup_of(t), device=device)
        for t in (scenes.cornell_box(), scenes.blob(3)[0])])
    forest, forest_roots = pack_forest(merged, roots)
    multi = pack_multiroot(merged, np.append(roots, -1))
    return [(forest, forest_roots), (multi, np.arange(3))]


def leaf_root_case(device, seed=8):
    """Roots that start rays at leaves: blob(2) (LBVH leaf 4, a mask of 1
    on odd triangles and 2 on even) with each ray's root drawn from the
    rows and leaf entries (-2 - leaf) of the table, and 1000 incoherent
    rays aimed at the blob, some dead -> (packed, rays, roots)."""
    tris = scenes.blob(2)[0]
    mask = np.where(np.arange(tris.shape[0]) % 2 == 1, 1, 2).astype(
        np.uint32)
    packed = pack_scene(rtk_tpu_torch.build_scene(
        _soup_of(tris), rtk_tpu_torch.BuildConfig(leaf_size=4),
        device=device), tri_mask=mask)
    rng = np.random.default_rng(seed)
    n = 1000
    n_leaves = packed.tris.shape[0] // packed.leaf_size
    entries = np.concatenate([np.arange(packed.num_nodes),
                              -2 - np.arange(n_leaves)])
    roots = torch.as_tensor(rng.choice(entries, n), dtype=torch.int32,
                            device=device)
    rays = rtk_tpu_torch.Rays.make(
        rng.normal(size=(n, 3)) * 1.5, rng.normal(size=(n, 3)) * 0.2
        - rng.normal(size=(n, 3)) * 1.5, 0.0,
        np.where(rng.random(n) < 0.1, 0.0, 3.0e38), device=device)
    return packed, rays, roots


@pytest.mark.parametrize("kw", [{}, {"mode": "any"}, {"filter_mask": 1}],
                         ids=["closest", "any", "mask"])
def test_leaf_roots_match_reference(cuda, kw):
    """A root of -2 - leaf starts the traversal at that leaf: the kernel
    equals its plain version bit for bit, counts included, through the
    checking front end and the rounds' unchecked launch."""
    packed, rays, roots = leaf_root_case(cuda)
    got, want = _both(packed, rays, ray_roots=roots, stats=True, **kw)
    _assert_same(got[0], want[0])
    assert torch.equal(got[1], want[1])
    leafy = roots <= -2
    live = leafy & (rays.max_t > rays.min_t)
    assert got[0].hit[leafy].any()
    assert bool((got[1][2][live] == 1).all() and (got[1][1][leafy] == 0).all())
    unchecked = packet_trace._trace_rooted(packet_trace.CARD, packed, rays,
                                           roots, **kw)
    _assert_same(unchecked, want[0])
    bad = roots.clone()
    bad[0] = -1
    with pytest.raises(ValueError, match="root rows"):
        packet_trace.trace_packets(packed, rays, ray_roots=bad)
    bad[0] = -2 - packed.tris.shape[0] // packed.leaf_size
    with pytest.raises(ValueError, match="root rows"):
        packet_trace.trace_packets(packed, rays, ray_roots=bad)


def test_roots_variant_matches_reference(cuda):
    """Per-packet and per-ray roots, dead rays and an empty root row: the
    kernel's roots variant equals its plain version bit for bit."""
    rng = np.random.default_rng(4)
    n = 1000
    dead = rng.random(n) < 0.2
    rays = rtk_tpu_torch.Rays.make(
        rng.normal(size=(n, 3)) * 0.3 + [0, 0, 3.0],
        rng.normal(size=(n, 3)) * 0.3 + [0, 0, -1.0], 0.0,
        np.where(dead, 0.0, 3.0e38), device=cuda)
    for packed, roots in _two_blas_forests(cuda):
        per_ray = torch.as_tensor(roots[rng.integers(0, len(roots), n)],
                                  dtype=torch.int32, device=cuda)
        for kw in (dict(packet_roots=roots[[1, 0, 1, 0, 0, 1, 1, 0]]),
                   dict(ray_roots=per_ray),
                   dict(ray_roots=per_ray, mode="any"),
                   dict(ray_roots=per_ray, defer_uv=True)):
            before = packet_trace.ROOTS_LAUNCHES
            got, want = _both(packed, rays, **kw)
            assert packet_trace.ROOTS_LAUNCHES == before + 1
            _assert_same(got, want)
            assert not got.hit[torch.as_tensor(dead, device=cuda)].any()
            assert got.hit.any()
        if len(roots) == 3:  # rays rooted at the empty row never hit
            empty = per_ray == int(roots[2])
            assert empty.any() and not got.hit[empty].any()


def test_instanced_kernel_matches_reference(cuda):
    """The whole instanced trace through the roots variant equals the same
    trace through the plain version, exact residual included."""
    from rtk_tpu_torch.instancing import (build_instanced, pack_instanced,
                                          trace_closest_instanced_packets)

    rng = np.random.default_rng(9)
    blas = [rtk_tpu_torch.build_scene(_soup_of(t), device=cuda)
            for t in (scenes.blob(2)[0],
                      scenes.box([-0.5, -0.5, -0.5], [0.5, 0.5, 0.5]))]
    tf = np.zeros((12, 3, 4), np.float32)
    tf[:, :, :3] = np.eye(3) * (0.5 + rng.random((12, 1, 1)))
    tf[:, :, 3] = rng.random((12, 3)) * 8 - 4
    pscene = pack_instanced(build_instanced(blas, rng.integers(0, 2, 12), tf))
    rays = scenes.camera_rays((0, 2, 12), (0, 0, 0), (0, 1, 0), 45, 64, 64,
                              device=cuda)
    for c in (12, 1):
        before = packet_trace.ROOTS_LAUNCHES
        got, gi = trace_closest_instanced_packets(pscene, rays,
                                                  max_candidates=c)
        assert packet_trace.ROOTS_LAUNCHES > before
        want, wi = trace_closest_instanced_packets(pscene, rays,
                                                   max_candidates=c,
                                                   plain=True)
        _assert_same(got, want)
        assert torch.equal(gi, wi) and got.hit.any()


# Predicates of the filter variant: the mask filter's twin, ray identity,
# test_packet.py's triangle-and-t filter, and one whose expression holds
# many live values at once (floor division and remainder on negatives,
# mixed int/float promotion, where, abs).
FILTERS = {
    "odd_tri": lambda c: c.triangle_index % 2 == 1,
    "even_ray": lambda c: c.ray_index % 2 == 0,
    "tri_t": lambda c: (c.triangle_index % 3 == 1) & (c.t > 2.0),
    "heavy": lambda c: (
        (torch.where(c.u > c.v, c.u * 3.0 - c.v, c.v // 0.125 - c.t)
         + abs(c.triangle_index - 4096) % -7 * 0.5
         - (c.ray_index // -3) % 5 / (c.t + 1.0)
         < (c.mesh_index - 2) * 1.5 + c.t % 0.75 * 4.0)
        | ((c.triangle_index ^ c.ray_index) & 12 == 4)),
}


@pytest.mark.parametrize("name", sorted(FILTERS))
def test_filter_variant_matches_reference(cuda, name):
    """The filter build of each predicate equals its plain version (the
    callable on torch tensors) bit for bit, on LBVH and SAH tables, with
    sorted rays (the caller's ray index through the permutation), any-hit
    and defer_uv; one launch each."""
    flt = rtk_tpu_torch.jit_filter(FILTERS[name])
    v, f = scenes.blob(4)[1:]
    tables = (pack_scene(rtk_tpu_torch.build_scene((v, f), device=cuda)),
              rtk_tpu_torch.build_sah_packed(
                  (v, f), rtk_tpu_torch.BuildConfig(leaf_size=16),
                  step_quant=True, device=cuda))
    rays = scenes.camera_rays((0, 0, 3.0), (0, 0, 0), (0, 1, 0), 45, 160,
                              160, order="morton", device=cuda)
    for packed in tables:
        for kw in (dict(), dict(sort_rays=True), dict(mode="any"),
                   dict(defer_uv=True)):
            before = packet_trace.FILTER_LAUNCHES
            got, want = _both(packed, rays, filter_fn=flt, **kw)
            assert packet_trace.FILTER_LAUNCHES == before + 1
            _assert_same(got, want)
    assert got.hit.any()


def test_filter_variant_equals_mask_filter(cuda):
    v, f = scenes.blob(4)[1:]
    mask = np.where(np.arange(f.shape[0]) % 2 == 1, 1, 2).astype(np.uint32)
    tracer = rtk_tpu_torch.Tracer(
        rtk_tpu_torch.build_scene((v, f), device=cuda), tri_mask=mask)
    rays = scenes.camera_rays((0, 0, 3.0), (0, 0, 0), (0, 1, 0), 45, 192,
                              192, order="morton", device=cuda)
    flt = rtk_tpu_torch.jit_filter(FILTERS["odd_tri"])
    _assert_same(tracer.closest(rays, filter_fn=flt),
                 tracer.closest(rays, filter_mask=1))
    a, b = tracer.any(rays, filter_fn=flt), tracer.any(rays, filter_mask=1)
    for field in ("hit", "slot", "t"):
        assert torch.equal(getattr(a, field), getattr(b, field)), field


@pytest.mark.parametrize("mode", ["closest", "any"])
def test_stats_variant_matches_reference(cuda, mode):
    """Per-ray counts from the kernel equal the plain version's; steps =
    internal + leaf pops; any-hit counts <= closest-hit counts."""
    v, f = scenes.blob(4)[1:]
    packed = pack_scene(rtk_tpu_torch.build_scene((v, f), device=cuda))
    rays = scenes.camera_rays((0, 0, 3.0), (0, 0, 0), (0, 1, 0), 45, 160,
                              160, order="morton", device=cuda)
    before = packet_trace.STATS_LAUNCHES
    got, counts = packet_trace.trace_packets(packed, rays, mode=mode,
                                             stats=True)
    torch.cuda.synchronize()
    assert packet_trace.STATS_LAUNCHES == before + 1
    want, want_counts = packet_trace.trace_packets_reference(
        packed, rays, mode=mode, stats=True)
    _assert_same(got, want)
    assert torch.equal(counts, want_counts)
    assert (counts >= 0).all() and torch.equal(counts[0],
                                               counts[1] + counts[2])
    _, closest = packet_trace.trace_packets(packed, rays, stats=True)
    assert (counts <= closest).all()


def _sah_tables(device, tris):
    """blob's step-quantized SAH tree with leaf 16, packed 8- and 16-wide
    with a tri_mask (1, 2, 3 by triangle index mod 3)."""
    from rtk_tpu_torch.trace.packed import pack_binary_tree
    from rtk_tpu_torch.utils.native_sah import NativeOracle

    tree = NativeOracle(tris.reshape(-1, 9), leaf_max=16,
                        step_quant=True).export_tree()
    mask = (np.arange(tris.shape[0]) % 3 + 1).astype(np.uint32)
    return {w: pack_binary_tree(tris, *tree, leaf_size=16, branching=w,
                                tri_mask=mask, device=device)
            for w in (8, 16)}


def test_w16_variant_matches_reference(cuda):
    """The 16-wide instantiation equals its plain version bit for bit
    (counts too) in every mode, with a filter predicate, and agrees with
    the 8-wide tables of the same tree."""
    tables = _sah_tables(cuda, scenes.blob(4)[0])
    p16 = tables[16]
    rays = scenes.camera_rays((0, 0, 3.0), (0, 0, 0), (0, 1, 0), 45, 128,
                              128, order="morton", device=cuda)
    flt = rtk_tpu_torch.jit_filter(FILTERS["tri_t"])
    for kw in (dict(), dict(mode="any"), dict(filter_mask=2),
               dict(defer_uv=True), dict(sort_rays=True),
               dict(filter_fn=flt)):
        before = packet_trace.W16_LAUNCHES
        got, want = _both(p16, rays, **kw)
        assert packet_trace.W16_LAUNCHES == before + 1
        _assert_same(got, want)
    got, counts = packet_trace.trace_packets(p16, rays, stats=True)
    want, want_counts = packet_trace.trace_packets_reference(p16, rays,
                                                             stats=True)
    _assert_same(got, want)
    assert torch.equal(counts, want_counts)
    w8 = packet_trace.trace_packets(tables[8], rays)
    assert torch.equal(w8.hit, got.hit) and torch.equal(w8.t, got.t)


def test_w16_roots_variant_matches_reference(cuda):
    """A 16-wide forest (two trees, root rows 0 and 1) through per-ray
    roots: kernel == plain."""
    from rtk_tpu_torch.trace.packed import pack_binary_tree

    tri_v, *tree, roots = chain_forest(60)
    packed = pack_binary_tree(tri_v, *tree, roots, leaf_size=1,
                              branching=16, device=cuda)
    rng = np.random.default_rng(5)
    n = 2048
    rays = rtk_tpu_torch.Rays.make(rng.normal(size=(n, 3)) * 3.0,
                                   rng.normal(size=(n, 3)), device=cuda)
    per_ray = torch.as_tensor(rng.integers(0, 2, n), dtype=torch.int32,
                              device=cuda)
    before = packet_trace.ROOTS_LAUNCHES
    got, want = _both(packed, rays, ray_roots=per_ray)
    assert packet_trace.ROOTS_LAUNCHES == before + 1
    _assert_same(got, want)


def test_march_variant_matches_reference(cuda):
    """The march instantiation equals its plain version bit for bit (t, u,
    v, slot and the per-ray counts summed over cells) on random, windowed,
    dead and camera rays, closest and any, with and without the mask
    filter; and meets the flat trace's parity bar."""
    from rtk_tpu_torch.testing.grid import build_grid, trace_packets_march

    tris = scenes.blob(4)[0]
    mask = (np.arange(tris.shape[0]) % 2 + 1).astype(np.uint32)
    grid = build_grid(tris, config=rtk_tpu_torch.BuildConfig(leaf_size=8),
                      march=True, tri_mask=mask, device=cuda)
    rng = np.random.default_rng(8)
    n = 4096
    u = rng.random(n)
    batches = [
        rtk_tpu_torch.Rays.make(
            rng.normal(size=(n, 3)) * 0.6, rng.normal(size=(n, 3)),
            np.where(u < 0.3, 0.2, 0.0),
            np.where(u < 0.1, 0.0, np.where(u < 0.3, 0.9, 3.0e38)),
            device=cuda),
        scenes.camera_rays((0, 0, 3.0), (0, 0, 0), (0, 1, 0), 45, 64, 64,
                           order="morton", device=cuda)]
    for rays in batches:
        for kw in (dict(), dict(mode="any"), dict(filter_mask=1)):
            before = packet_trace.MARCH_LAUNCHES
            got, counts = trace_packets_march(grid, rays, stats=True, **kw)
            torch.cuda.synchronize()
            assert packet_trace.MARCH_LAUNCHES == before + 1
            want, want_counts = trace_packets_march(grid, rays, stats=True,
                                                    plain=True, **kw)
            _assert_same(got, want)
            assert torch.equal(counts, want_counts)
            flat = packet_trace.trace_packets(grid.flat, rays, **kw)
            assert torch.equal(got.hit, flat.hit)
            if kw.get("mode") != "any":
                assert bool(((got.t - flat.t).abs()
                             <= 1e-6 * (1 + flat.t.abs())).all())


def chain_grid(device):
    """Two blob(2)s at opposite corners of a box and 160 small triangles
    strewn through it, on an 8 x 8 x 8 march grid (LBVH leaf-4 cell trees,
    a tri_mask): the cells between the blobs are empty or hold a few
    triangles, so a ray's chain crosses both."""
    from rtk_tpu_torch.testing.grid import build_grid

    rng = np.random.default_rng(21)
    b = scenes.blob(2)[0] * 0.8
    c = rng.uniform(-3.2, 3.2, size=(160, 1, 3))
    tris = np.concatenate([b - 2.5, b + 2.5,
                           c + rng.normal(size=(160, 3, 3)) * 0.35])
    mask = (np.arange(tris.shape[0]) % 2 + 1).astype(np.uint32)
    return build_grid(tris.astype(np.float32),
                      config=rtk_tpu_torch.BuildConfig(leaf_size=4),
                      dims=(8, 8, 8), march=True, tri_mask=mask,
                      device=device)


def chain_rays(n, device, seed=22):
    """The first n of a fixed 1000-ray batch for chain_grid, by ray index
    mod 8: from outside the low corner along the diagonal (long chains
    through empty cells, hits mid-chain), from inside the box in random
    directions, and from near the centre out through each of the six
    faces; every 5th ray has min_t 0.5, every 7th max_t 2, every 9th is
    dead (max_t 0)."""
    rng = np.random.default_rng(seed)
    i = np.arange(1000)
    k = i % 8
    o = rng.normal(size=(1000, 3)) * 0.5
    d = rng.normal(size=(1000, 3)) * 0.3
    o[k == 0] -= 6.0
    d[k == 0] = 1.0 + d[k == 0] * 0.5
    o[k == 1] = rng.uniform(-3.5, 3.5, size=(int((k == 1).sum()), 3))
    d[k == 1] = rng.normal(size=(int((k == 1).sum()), 3))
    for face in range(6):
        d[k == 2 + face, face // 2] = -1.0 if face % 2 else 1.0
    mint = np.where(i % 5 == 0, 0.5, 0.0)
    maxt = np.where(i % 9 == 0, 0.0, np.where(i % 7 == 0, 2.0, 3.0e38))
    return rtk_tpu_torch.Rays.make(o[:n], d[:n], mint[:n], maxt[:n],
                                   device=device)


def long_tail_scene(device):
    """A cloud of 4,000 small random triangles in [-1, 1]^3 under a lid of
    two triangles at y = 3 (LBVH leaf 4)."""
    rng = np.random.default_rng(24)
    cloud = (rng.uniform(-1.0, 1.0, size=(4000, 1, 3))
             + rng.normal(size=(4000, 3, 3)) * 0.03)
    lid = np.array([[[-1, 3, -1], [1, 3, -1], [1, 3, 1]],
                    [[-1, 3, -1], [1, 3, 1], [-1, 3, 1]]])
    return pack_scene(rtk_tpu_torch.build_scene(
        _soup_of(np.concatenate([cloud, lid]).astype(np.float32)),
        device=device))


def long_tail_rays(n, device, seed=23):
    """The first n of a fixed 1000-ray batch for long_tail_scene: 31 rays
    in 32 come down onto the lid and end at one of its leaves (3.5 entries
    popped on average); every 32nd crosses the cloud from the side,
    through the boxes of much of the tree (41 on average)."""
    rng = np.random.default_rng(seed)
    i = np.arange(1000)
    skim = i % 32 == 31
    m = int(skim.sum())
    o = np.stack([rng.uniform(-0.9, 0.9, 1000), np.full(1000, 4.0),
                  rng.uniform(-0.9, 0.9, 1000)], axis=1)
    d = np.tile([0.0, -1.0, 0.0], (1000, 1)) + rng.normal(
        size=(1000, 3)) * 0.05
    o[skim] = np.stack([np.full(m, -1.5), rng.uniform(-0.9, 0.9, m),
                        rng.uniform(-0.9, 0.9, m)], axis=1)
    d[skim] = np.stack([np.ones(m), rng.normal(size=m) * 0.1,
                        rng.normal(size=m) * 0.1], axis=1)
    return rtk_tpu_torch.Rays.make(o[:n], d[:n], 0.0, 3.0e38, device=device)


@pytest.mark.parametrize("n", [1, 127, 129, 1000])
def test_march_cell_chains(cuda, n):
    """The march kernel equals its plain version bit for bit, counts
    included, on chains that cross many cells, empty ones among them,
    start inside the grid or leave it through each face, retire mid-chain
    at an any-hit, or never start (dead rays), at ragged batch sizes."""
    from rtk_tpu_torch.testing.grid import trace_packets_march

    grid = chain_grid(cuda)
    rays = chain_rays(n, cuda)
    for kw in (dict(), dict(mode="any"), dict(filter_mask=1)):
        before = packet_trace.MARCH_LAUNCHES
        got, counts = trace_packets_march(grid, rays, stats=True, **kw)
        torch.cuda.synchronize()
        assert packet_trace.MARCH_LAUNCHES == before + 1
        want, want_counts = trace_packets_march(grid, rays, stats=True,
                                                plain=True, **kw)
        _assert_same(got, want)
        assert torch.equal(counts, want_counts)


@pytest.mark.parametrize("n", [1, 127, 129, 1000])
def test_any_hit_long_tail(cuda, n):
    """Any-hit where most rays end at their first leaf and a few walk much
    of the tree: the kernel equals its plain version bit for bit, counts
    included, at ragged batch sizes (unsorted, so the warps keep the
    mix)."""
    packed = long_tail_scene(cuda)
    rays = long_tail_rays(n, cuda)
    got, want = _both(packed, rays, mode="any", sort_rays=False, stats=True)
    _assert_same(got[0], want[0])
    assert torch.equal(got[1], want[1])


@pytest.mark.parametrize("leaf_size,count,width", TIE_CASES)
def test_kernel_ties_and_leaf_sizes(cuda, leaf_size, count, width):
    """Children at equal entry distance (ties by slot), coincident
    triangles in two leaves (the first found wins) and every leaf-loop
    shape: kernel == plain bit for bit, counts included, closest and any
    (which leaves at the nearest child with entries still stacked), the
    mask filter and a filter predicate."""
    from rtk_tpu_torch.trace.packed import pack_binary_tree

    tri_v, *tree = tie_tree(64, count)
    mask = (np.arange(tri_v.shape[0]) % 3 + 1).astype(np.uint32)
    packed = pack_binary_tree(tri_v, *tree, leaf_size=leaf_size,
                              branching=width, tri_mask=mask, device=cuda)
    rays = tie_rays(3000, cuda)
    flt = rtk_tpu_torch.jit_filter(FILTERS["odd_tri"])
    for kw in (dict(), dict(mode="any"), dict(filter_mask=2),
               dict(filter_fn=flt), dict(filter_fn=flt, mode="any")):
        got, counts = packet_trace.trace_packets(packed, rays, stats=True,
                                                 sort_rays=False, **kw)
        want, want_counts = packet_trace.trace_packets_reference(
            packed, rays, stats=True, sort_rays=False, **kw)
        _assert_same(got, want)
        assert torch.equal(counts, want_counts), kw
    assert got.hit.any()


def test_kernel_deep_tree_within_the_stack(cuda):
    """A chain whose traversal stack comes close to the compiled one."""
    from rtk_tpu_torch.trace.packed import pack_binary_tree

    tri_v, *tree, roots = chain_forest(240)
    packed = pack_binary_tree(tri_v, *tree, roots, leaf_size=1, device=cuda)
    cap = library.load_kernel().rtk_packet_trace_max_stack()
    assert cap // 2 < packed.stack_size <= cap
    rays = tie_rays(2000, cuda)
    roots_t = torch.ones(rays.count, dtype=torch.int32, device=cuda)
    got, counts = packet_trace.trace_packets(packed, rays, stats=True,
                                             ray_roots=roots_t)
    want, want_counts = packet_trace.trace_packets_reference(
        packed, rays, stats=True, ray_roots=roots_t)
    _assert_same(got, want)
    assert torch.equal(counts, want_counts)


def _trace_bits(packed, rays, **kw):
    """The kernel and its plain version on `rays`, unsorted, with stats:
    every output and count equal bit for bit."""
    got, counts = packet_trace.trace_packets(packed, rays, stats=True,
                                             sort_rays=False, **kw)
    want, want_counts = packet_trace.trace_packets_reference(
        packed, rays, stats=True, sort_rays=False, **kw)
    _assert_same(got, want)
    assert torch.equal(counts, want_counts), kw
    return got


@pytest.mark.parametrize("leaf_size", [1, 4, 8, 16, 40])
def test_kernel_mask_leaves(cuda, leaf_size):
    """The mask filter on mask_tree's leaves (a leaf no mask passes, NaN
    padding that passes the mask between masked and unmasked rows, a leaf
    longer than 32 rows) under single- and multi-bit masks, 8 and 16
    wide, closest and any."""
    from rtk_tpu_torch.trace.packed import pack_binary_tree

    tree, mask = mask_tree(leaf_size)
    rays = tie_rays(3000, cuda)
    hits = 0
    for width in (8, 16):
        packed = pack_binary_tree(*tree, leaf_size=leaf_size,
                                  branching=width, tri_mask=mask,
                                  device=cuda)
        for qmask in MASK_QMASKS:
            for mode in ("closest", "any"):
                before = packet_trace.MASK_LAUNCHES
                got = _trace_bits(packed, rays, mode=mode, filter_mask=qmask)
                assert packet_trace.MASK_LAUNCHES == before + 1
                hits += int(got.hit.sum())
    assert hits > 0


@pytest.mark.parametrize("n", [9, 12, 15, 16])
def test_w16_wide_nodes_with_ties(cuda, n):
    """16-wide roots of 9 to 16 live children whose slots 7 and 8 lie at
    one entry distance (ties kept in slot order across the halves of the
    node), closest, any and under a mask."""
    from rtk_tpu_torch.trace.packed import pack_binary_tree

    tri_v, *tree = wide_tie_tree(n)
    mask = (np.arange(tri_v.shape[0]) % 3 + 1).astype(np.uint32)
    packed = pack_binary_tree(tri_v, *tree, leaf_size=4, branching=16,
                              tri_mask=mask, device=cuda)
    rays = tie_rays(3000, cuda)
    for kw in (dict(), dict(mode="any"), dict(filter_mask=2)):
        before = packet_trace.W16_LAUNCHES
        got = _trace_bits(packed, rays, **kw)
        assert packet_trace.W16_LAUNCHES == before + 1
    assert got.hit.any()


def _shear_axis_rays(batch, device, seed=41):
    """Rays aimed at blob(4) from about 3 units out whose shear axes (the
    dominant |d| component, ties x, y, z) are set ray by ray, and their
    mixed-axis share -> (Rays, share).  "cycle": 4096 rays whose lanes
    cycle kz 0, 1, 2 in every warp, with ties of |d| (all three equal: x;
    |dy| = |dz| > |dx|: y); "one_axis": 4096 rays of kz 2, the control;
    "ragged": 1000 rays of random axes, a fifth dead, a short last warp."""
    from rtk_tpu_torch.utils.stats import mixed_axis_share

    rng = np.random.default_rng(seed)
    n = 1000 if batch == "ragged" else 4096
    axis = {"cycle": np.arange(n) % 3, "one_axis": np.full(n, 2),
            "ragged": rng.integers(0, 3, n)}[batch]

    def signs(shape):
        return np.where(rng.random(shape) < 0.5, -1.0, 1.0)

    d = np.clip(rng.normal(size=(n, 3)) * 0.3, -0.9, 0.9)
    d[np.arange(n), axis] = signs(n)
    if batch == "cycle":
        d[::7] = signs(d[::7].shape)
        d[4::11] = signs(d[4::11].shape) * [0.25, 1.0, 1.0]
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    o = -3.0 * d + rng.normal(size=(n, 3)).astype(np.float32) * 0.2
    dead = rng.random(n) < (0.2 if batch == "ragged" else 0.0)
    rays = rtk_tpu_torch.Rays.make(o, d, 0.0, np.where(dead, 0.0, 3.0e38),
                                   device=device)
    return rays, mixed_axis_share(rays.direction)


def _shear_axis_tables(variant, device):
    """The tables of each variant: blob(4) LBVH (leaf 4) with a tri_mask
    of 1, 2, 3 by triangle; its step-quantized SAH tree packed 16 wide for
    "w16"; the two-BLAS forest for "roots"."""
    if variant == "w16":
        return _sah_tables(device, scenes.blob(4)[0])[16]
    if variant == "roots":
        return _two_blas_forests(device)[0][0]
    v, f = scenes.blob(4)[1:]
    mask = (np.arange(f.shape[0]) % 3 + 1).astype(np.uint32)
    return pack_scene(rtk_tpu_torch.build_scene((v, f), device=device),
                      tri_mask=mask)


SHEAR_AXIS_VARIANTS = {
    "closest": {}, "any": {"mode": "any"}, "mask": {"filter_mask": 2},
    "defer_uv": {"defer_uv": True}, "stats": {"stats": True},
    "filter": {"filter_fn": "odd_tri"}, "roots": {"ray_roots": None},
    "w16": {}}


@pytest.mark.parametrize("variant", sorted(SHEAR_AXIS_VARIANTS))
@pytest.mark.parametrize("batch", ["cycle", "one_axis", "ragged"])
def test_kernel_mixed_shear_axes(cuda, batch, variant):
    """Warps whose rays hold more than one shear axis take the leaf test
    that reads the axis from the ray, and one-axis warps the per-axis
    copies: every variant equals its plain version bit for bit on both
    (the stats variant's five count rows too), unsorted so that the warps
    are the batch's own."""
    rays, share = _shear_axis_rays(batch, cuda)
    if batch == "cycle":
        assert share == 1.0
    elif batch == "one_axis":
        assert share == 0.0
    else:
        assert share > 0.0
    packed = _shear_axis_tables(variant, cuda)
    kw = dict(SHEAR_AXIS_VARIANTS[variant])
    if variant == "filter":
        kw["filter_fn"] = rtk_tpu_torch.jit_filter(FILTERS["odd_tri"])
    if variant == "roots":
        roots = _two_blas_forests(cuda)[0][1]
        kw["ray_roots"] = torch.as_tensor(
            roots[np.arange(rays.count) % len(roots)], dtype=torch.int32,
            device=cuda)
    before = packet_trace.KERNEL_LAUNCHES
    got = packet_trace.trace_packets(packed, rays, sort_rays=False, **kw)
    torch.cuda.synchronize()
    assert packet_trace.KERNEL_LAUNCHES == before + 1
    want = packet_trace.trace_packets_reference(packed, rays,
                                                sort_rays=False, **kw)
    if variant == "stats":
        assert torch.equal(got[1], want[1])
        got, want = got[0], want[0]
    _assert_same(got, want)
    assert got.hit.any()


@pytest.mark.parametrize("kind", ["lbvh", "sah", "sah16"])
def test_kernel_on_refit_tables(cuda, kind):
    """The kernel against its plain version on tables refit to a moved
    frame (repack_bounds, refit_packed_binary at both widths), a tri_mask
    riding the refit; the refit front-ends launch it once a frame."""
    from rtk_tpu_torch.trace.packed import pack_binary_tree
    from rtk_tpu_torch.utils.native_sah import NativeOracle

    g0 = scenes.deforming_grid(0.0, n=48)
    frames = np.stack([scenes.deforming_grid(t, n=48) for t in (0.3, 0.6)])
    mask = (np.arange(g0.shape[0]) % 3 + 1).astype(np.uint32)
    if kind == "lbvh":
        scene = rtk_tpu_torch.build_scene(
            _soup_of(g0), rtk_tpu_torch.BuildConfig(leaf_size=8,
                                                    wide_nodes=False),
            device=cuda)
        packed = pack_scene(scene, tri_mask=mask)
    else:
        tree = NativeOracle(g0.reshape(-1, 9), leaf_max=16,
                            step_quant=True).export_tree()
        packed, scene = pack_binary_tree(
            g0, *tree, leaf_size=16, tri_mask=mask, return_refit_aux=True,
            branching=16 if kind == "sah16" else 8, device=cuda)
    rays = scenes.camera_rays((0, 3, 4), (0, 0, 0), (0, 1, 0), 50, 128, 128,
                              order="morton", device=cuda)
    before = packet_trace.KERNEL_LAUNCHES
    hits, _, refit_tables = packet_trace.trace_packets_refit(
        packed, scene, frames[0], rays, defer_uv=True)
    clip = packet_trace.trace_packets_refit_frames(
        packed, scene, frames, rays, defer_uv=True)
    torch.cuda.synchronize()
    assert packet_trace.KERNEL_LAUNCHES == before + 3
    assert hits.hit.any() and refit_tables.device == rays.device
    _assert_same(clip[0], hits)
    for kw in (dict(), dict(mode="any"), dict(filter_mask=2),
               dict(defer_uv=True), dict(sort_rays=False)):
        _assert_same(*_both(refit_tables, rays, **kw))
    _assert_same(hits, packet_trace.trace_packets_reference(
        refit_tables, rays, defer_uv=True))


def _on_cpu(obj):
    """A Scene or PackedScene with its tensors copied to the CPU."""
    import dataclasses

    return dataclasses.replace(obj, **{
        f.name: getattr(obj, f.name).cpu() for f in dataclasses.fields(obj)
        if isinstance(getattr(obj, f.name), torch.Tensor)})


def _cpu_bits(a):
    a = a.cpu()
    return a.view(torch.int32) if a.dtype == torch.float32 else a


def _zero_sign_only(got, want):
    """-> entries whose bits differ; raises unless each is a zero that
    differs in its sign alone (equal values)."""
    differ = _cpu_bits(got) != _cpu_bits(want)
    assert torch.equal(got.cpu()[differ], want.cpu()[differ])
    assert bool((got.cpu()[differ] == 0).all())
    return int(differ.sum())


# Frames of the 32-frame clip the refit cell runs (t = 0.05 k): k = 0, 5
# and 30 hold y values of +0.0 and -0.0, k = 7 and 31 none.
CLIP_FRAMES = (7, 0, 5, 30, 31)


@pytest.mark.parametrize("wide", [False, True])
def test_refit_frame_on_the_card(cuda, wide):
    """BASELINE config 4's frames as the benchmark's refit cell runs them:
    the 96 x 96 grid (LBVH leaf 8; the cell's has no wide arrays) refit
    frame after frame and its Tracer refreshed with no host sync, in 2
    refit launches (3 with wide node arrays) and 1 repack launch a frame,
    then one kernel launch for the frame's closest call.  Each frame's
    Scene and tables equal the same refit and repack on the CPU bit for
    bit, and the records the plain version's.  The card's eager version of
    the refit (the plain steps on CUDA tensors) agrees in value; where the
    sign of a zero bound differs from the CPU's, the test counts it."""
    from rtk_tpu_torch import scene as tscene
    from rtk_tpu_torch.builder import lbvh
    from rtk_tpu_torch.testing.carry import PACKED_ARRAYS, SCENE_ARRAYS
    from rtk_tpu_torch.trace import packed as tpacked

    scene = rtk_tpu_torch.build_scene(
        _soup_of(scenes.deforming_grid(0.0)),
        rtk_tpu_torch.BuildConfig(leaf_size=8, wide_nodes=wide),
        device=cuda)
    tracer = rtk_tpu_torch.Tracer(scene)
    cpu_scene, cpu_packed = _on_cpu(scene), _on_cpu(tracer.packed)
    rays = scenes.camera_rays((0, 3, 4), (0, 0, 0), (0, 1, 0), 50, 256, 256,
                              order="morton", device=cuda)
    eager_zero_signs = 0
    for k in CLIP_FRAMES:
        frame = torch.as_tensor(scenes.deforming_grid(0.05 * k), device=cuda)
        torch.cuda.synchronize()
        counters = (tscene.REFITS, tpacked.REPACKS, tscene.REFIT_LAUNCHES,
                    tpacked.REPACK_LAUNCHES)
        torch.cuda.set_sync_debug_mode("error")
        try:
            scene = rtk_tpu_torch.refit(scene, frame)
            tracer = tracer.refresh(scene)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        after = (tscene.REFITS, tpacked.REPACKS, tscene.REFIT_LAUNCHES,
                 tpacked.REPACK_LAUNCHES)
        assert [a - b for a, b in zip(after, counters)] == [
            1, 1, 3 if wide else 2, 1]
        cpu_scene = rtk_tpu_torch.refit(cpu_scene, frame.cpu())
        cpu_packed = tpacked.repack_bounds(cpu_packed, cpu_scene)
        for f in SCENE_ARRAYS:
            assert torch.equal(_cpu_bits(getattr(scene, f)),
                               _cpu_bits(getattr(cpu_scene, f))), (k, f)
        for f in PACKED_ARRAYS:
            assert torch.equal(_cpu_bits(getattr(tracer.packed, f)),
                               _cpu_bits(getattr(cpu_packed, f))), (k, f)
        eager = packet_trace.PLAIN.refit(scene, frame)
        eager_zero_signs += sum(
            _zero_sign_only(getattr(eager, f), getattr(scene, f))
            for f in ("leaf_min", "leaf_max", "bin_min", "bin_max",
                      "bounds_min", "bounds_max"))
    print(f"the card's eager refit differs from the kernel's in "
          f"{eager_zero_signs} zero signs over {len(CLIP_FRAMES)} frames")
    before = packet_trace.KERNEL_LAUNCHES
    hits = tracer.closest(rays)
    torch.cuda.synchronize()
    assert packet_trace.KERNEL_LAUNCHES == before + 1
    assert lbvh.REFIT_LEVELS == 13 and scene.num_leaves == 2304
    assert hits.hit.any()
    _assert_same(hits, packet_trace.trace_packets_reference(tracer.packed,
                                                            rays))


def test_refit_kernels_on_small_scenes(cuda):
    """refit_kernel and repack_kernel on the CPU refit tests' odd shapes (a
    one-leaf scene, padding rows, a shuffled soup, wide arrays and a
    tri_mask) equal the plain versions on CPU copies bit for bit."""
    from rtk_tpu_torch import scene as tscene
    from rtk_tpu_torch.testing.carry import PACKED_ARRAYS, SCENE_ARRAYS
    from rtk_tpu_torch.trace import packed as tpacked

    rng = np.random.default_rng(9)
    for t, leaf in ((3, 4), (301, 4), (300, 8), (1, 1)):
        base = (rng.normal(size=(t, 1, 3)) * 2.0
                + rng.normal(size=(t, 3, 3)) * 0.3).astype(np.float32)
        moved = (base
                 + rng.normal(size=base.shape) * 0.2).astype(np.float32)
        scene = rtk_tpu_torch.build_from_soup(
            base, config=rtk_tpu_torch.BuildConfig(leaf_size=leaf),
            device=cuda)
        mask = (np.arange(t) % 3 + 1).astype(np.uint32)
        packed = pack_scene(scene, tri_mask=mask)
        got = tscene.refit_kernel(scene,
                                  torch.as_tensor(moved, device=cuda))
        want = tscene.refit_reference(_on_cpu(scene),
                                      torch.from_numpy(moved))
        for f in SCENE_ARRAYS:
            assert torch.equal(_cpu_bits(getattr(got, f)),
                               _cpu_bits(getattr(want, f))), (t, f)
        got_p = tpacked.repack_kernel(packed, got)
        want_p = tpacked.repack_reference(_on_cpu(packed), want)
        for f in PACKED_ARRAYS:
            assert torch.equal(_cpu_bits(getattr(got_p, f)),
                               _cpu_bits(getattr(want_p, f))), (t, f)


def test_aot_refit_artifact_runs_its_own_refit(cuda, monkeypatch):
    """A "cuda" refit artifact refits and repacks with its embedded
    library's kernels (2 and 1 launches a frame; the library built from
    the sources is never asked for) and equals trace_packets_refit."""
    from rtk_tpu_torch import scene as tscene
    from rtk_tpu_torch.trace import packed as tpacked
    from rtk_tpu_torch.utils import aot

    tris = scenes.deforming_grid(0.0, n=16)
    cfg = rtk_tpu_torch.BuildConfig(leaf_size=8, wide_nodes=False)
    host = rtk_tpu_torch.build_from_soup(tris, config=cfg, device="cpu")
    scene = rtk_tpu_torch.build_from_soup(tris, config=cfg, device=cuda)
    packed = pack_scene(scene)
    rays = scenes.camera_rays((0, 3, 4), (0, 0, 0), (0, 1, 0), 50, 32, 32,
                              device=cuda)
    lr = aot.load_refit_trace(aot.export_refit_trace(
        pack_scene(host), host, rays.count, platforms=["cuda"]))
    frame = torch.as_tensor(scenes.deforming_grid(0.35, n=16), device=cuda)
    want, _, _ = packet_trace.trace_packets_refit(packed, scene, frame, rays)

    def refuse(*args, **kw):
        raise AssertionError("the artifact asked for the source build")

    monkeypatch.setattr(library, "load_kernel", refuse)
    before = tscene.REFIT_LAUNCHES, tpacked.REPACK_LAUNCHES
    got = lr(packed, frame, rays)
    torch.cuda.synchronize()
    assert (tscene.REFIT_LAUNCHES - before[0],
            tpacked.REPACK_LAUNCHES - before[1]) == (2, 1)
    _assert_same(got, want)


@pytest.mark.parametrize("compact", [True, False])
def test_render_path_runs_the_kernel(cuda, compact):
    """render_path on the card launches the kernel once a bounce, and the
    furnace identity (albedo 1, emission and background e: radiance / e
    is the whole number of live rays traced on that path) holds
    exactly."""
    from rtk_tpu_torch.models import path

    e, bounces = 0.5, 3
    tracer = rtk_tpu_torch.Tracer(rtk_tpu_torch.build_scene(
        _soup_of(scenes.blob(3)[0]), device=cuda))
    rays = scenes.camera_rays((0, 0, 3.0), (0, 0, 0), (0, 1, 0), 45, 128,
                              128, device=cuda)
    mats = path.Materials.make(np.ones((1, 3)), np.full((1, 3), e))
    assert mats.albedo.device.type == "cuda"  # the card by default
    tracer.packed
    before = packet_trace.KERNEL_LAUNCHES
    q = path.render_path(tracer, rays, mats,
                         torch.Generator(device=cuda).manual_seed(0),
                         bounces=bounces, background=(e, e, e),
                         compact=compact) / e
    torch.cuda.synchronize()
    launched = packet_trace.KERNEL_LAUNCHES - before
    # With compaction the loop ends early once no ray is alive.
    assert (2 <= launched <= bounces + 1 if compact
            else launched == bounces + 1)
    assert q.device.type == "cuda" and torch.equal(q, q.round())
    assert int(q.min()) == 1 and 2 <= int(q.max()) <= bounces + 1
    hit = tracer.closest(rays).hit
    assert torch.equal(q[:, 0] > 1, hit)  # a primary that hit went on


def test_render_path_uniforms_on_the_card(cuda, monkeypatch):
    """The bounce draws handed in by ray (render_path's uniforms): on the
    card one radiance, bit for bit, with compaction (buckets from 64 rays,
    so they drop dead rays) and the sort on or off; and the CPU's (plain
    version) within 1e-4 on at least 99% of the paths (a bounce origin
    that differs in the last bit may take the other side of an edge)."""
    from rtk_tpu_torch.models import path

    real = path._round_up_bucket
    monkeypatch.setattr(path, "_round_up_bucket",
                        lambda n, minimum: real(n, 64))
    tris = _soup_of(scenes.blob(3)[0])
    albedo, emission = [[0.7, 0.6, 0.5]], [[0.1, 0.1, 0.1]]
    rays = scenes.camera_rays((0, 0, 3.0), (0, 0, 0), (0, 1, 0), 45, 128,
                              128, device="cpu")
    u = torch.rand((3, rays.count, 2),
                   generator=torch.Generator().manual_seed(3))
    kw = dict(bounces=3, background=(0.2, 0.3, 0.4))
    out = {}
    for dev in ("cpu", cuda):
        tracer = rtk_tpu_torch.Tracer(rtk_tpu_torch.build_scene(
            tris, device=dev))
        mats = path.Materials.make(albedo, emission, device=dev)
        r = rtk_tpu_torch.Rays(*(getattr(rays, f).to(dev) for f in (
            "origin", "direction", "min_t", "max_t")))
        out[str(dev)] = [path.render_path(tracer, r, mats,
                                          uniforms=u.to(dev), compact=c,
                                          sort_rays=s, **kw)
                         for c in (True, False) for s in (True, False)]
    card = out[str(cuda)]
    assert all(torch.equal(q, card[0]) for q in card[1:])
    cpu = out["cpu"][0]
    close = ((card[0].cpu() - cpu).abs() <= 1e-4).all(dim=1)
    assert float(close.float().mean()) >= 0.99
    assert float(cpu.amax()) > 0.2


def test_render_direct_and_ao_on_the_card_equal_the_cpu(cuda, monkeypatch):
    """No random draw in render_direct: the card's image equals the
    CPU's (plain version) within 1e-5 on at least 99% of the pixels (the
    shadow rays' origins differ in the last bit between the two devices,
    so a pixel on a shadow's edge may flip).  render_ao with the same
    uniforms on both devices: its launches are any-hit launches and its
    values equal the CPU's exactly on at least 99% of the pixels (a probe
    that grazes an edge may flip one sample)."""
    from rtk_tpu_torch.models import path

    soup = _soup_of(scenes.cornell_box())
    light = dict(light_pos=(0.5, 0.95, 0.5), light_color=(1.0, 1.0, 1.0))
    imgs = []
    for dev in (cuda, "cpu"):
        tracer = rtk_tpu_torch.Tracer(rtk_tpu_torch.build_scene(soup,
                                                                device=dev))
        rays = scenes.cornell_camera(48, 48, device=dev)
        mats = path.Materials.make([[0.7, 0.6, 0.5]], device=dev)
        imgs.append(path.render_direct(tracer, rays, mats, **light).cpu())
    assert float(imgs[0].max()) > 0.01
    close = ((imgs[0] - imgs[1]).abs() <= 1e-5).all(dim=1)
    assert float(close.float().mean()) >= 0.99, float(close.float().mean())
    # Both devices draw the same uniforms, sample by sample.
    real = path.cosine_sample
    draws = torch.rand((8, 2, 48 * 48),
                       generator=torch.Generator().manual_seed(1))
    state = {}

    def replay(generator, normal, u1=None, u2=None):
        u = draws[state["sample"]].to(normal.device)
        state["sample"] += 1
        return real(None, normal, u[0], u[1])

    monkeypatch.setattr(path, "cosine_sample", replay)
    aos = []
    for dev in (cuda, "cpu"):
        tracer = rtk_tpu_torch.Tracer(rtk_tpu_torch.build_scene(soup,
                                                                device=dev))
        tracer.packed
        state["sample"] = 0
        before = packet_trace.ANY_LAUNCHES
        aos.append(path.render_ao(
            tracer, scenes.cornell_camera(48, 48, device=dev), None,
            samples=8, max_dist=0.5).cpu())
        assert packet_trace.ANY_LAUNCHES == before + 8 * (dev == cuda)
    same = float((aos[0] == aos[1]).float().mean())
    assert same >= 0.99, same
    assert torch.equal(aos[0] * 8, (aos[0] * 8).round())
    assert 0.05 < float(aos[0].mean()) < 0.99


def _launch_case(device):
    """blob(4) LBVH tables and 40,000 incoherent rays, dead ones among
    them."""
    v, f = scenes.blob(4)[1:]
    packed = pack_scene(rtk_tpu_torch.build_scene((v, f), device=device))
    rng = np.random.default_rng(21)
    n = 40000
    rays = rtk_tpu_torch.Rays.make(
        rng.normal(size=(n, 3)) * 1.5, rng.normal(size=(n, 3)), 0.0,
        np.where(rng.random(n) < 0.1, 0.0, 3.0e38), device=device)
    return packed, torch.cat([rays.origin.T, rays.direction.T,
                              rays.min_t[None], rays.max_t[None]]).contiguous()


def test_launches_in_a_row_and_on_two_streams(cuda):
    """Launches back to back on one stream, and on two streams at once,
    each trace every ray, equal to the plain version with counts (no
    launch leaves state behind for the next)."""
    packed, rows = _launch_case(cuda)
    kw = dict(leaf_size=packed.leaf_size, stack_size=packed.stack_size,
              stats=True)
    want = packet_trace.packet_trace_reference(packed.nodes, packed.tris,
                                               rows, **kw)

    def same(got):
        for g, w in zip(got, want):
            assert torch.equal(g, w)

    one = [packet_trace.packet_trace_kernel(packed.nodes, packed.tris, rows,
                                            **kw) for _ in range(4)]
    torch.cuda.synchronize()
    for got in one:
        same(got)
    streams = [torch.cuda.Stream() for _ in range(2)]
    torch.cuda.synchronize()
    two = []
    for _ in range(3):
        for s in streams:
            with torch.cuda.stream(s):
                two.append(packet_trace.packet_trace_kernel(
                    packed.nodes, packed.tris, rows, **kw))
    torch.cuda.synchronize()
    for got in two:
        same(got)


def test_instanced_rounds_make_no_roots_check(cuda, monkeypatch):
    """The rounds launch from pack_instanced's checked root rows: no launch
    of theirs checks its roots on the device (a host sync), while a
    caller's roots are still checked."""
    from rtk_tpu_torch.instancing import (build_instanced, pack_instanced,
                                          trace_closest_instanced_packets)

    seen = []
    check = packet_trace._check_roots

    def spy(roots, nodes, rays8, w, leaves, in_range=False):
        seen.append(in_range)
        return check(roots, nodes, rays8, w, leaves, in_range)

    monkeypatch.setattr(packet_trace, "_check_roots", spy)
    rng = np.random.default_rng(9)
    blas = [rtk_tpu_torch.build_scene(_soup_of(t), device=cuda)
            for t in (scenes.blob(2)[0],
                      scenes.box([-0.5, -0.5, -0.5], [0.5, 0.5, 0.5]))]
    tf = np.zeros((12, 3, 4), np.float32)
    tf[:, :, :3] = np.eye(3) * (0.5 + rng.random((12, 1, 1)))
    tf[:, :, 3] = rng.random((12, 3)) * 8 - 4
    pscene = pack_instanced(build_instanced(blas, rng.integers(0, 2, 12), tf))
    rays = scenes.camera_rays((0, 2, 12), (0, 0, 0), (0, 1, 0), 45, 64, 64,
                              device=cuda)
    before = packet_trace.ROOTS_LAUNCHES
    hits, _ = trace_closest_instanced_packets(pscene, rays)
    assert packet_trace.ROOTS_LAUNCHES > before and hits.hit.any()
    assert seen and all(seen)
    bad = torch.full((rays.count,), pscene.packed.num_nodes,
                     dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="root rows"):
        packet_trace.trace_packets(pscene.packed, rays, ray_roots=bad)
    with pytest.raises(ValueError, match="root rows"):
        packet_trace.packet_trace_kernel(
            pscene.packed.nodes, pscene.packed.tris,
            torch.zeros((8, rays.count), device=cuda),
            leaf_size=pscene.packed.leaf_size,
            stack_size=pscene.packed.stack_size, roots=bad)


def test_aot_cuda_export_embeds_the_kernel(cuda):
    """The counterpart of the reference's TPU cross-lowering test: a
    "cuda" artifact, exported from tables on the CPU, embeds the nvcc
    build; loaded, it runs that library on the card (no build for it) and
    equals the direct call bit for bit, filter build included; it refuses
    rays on the CPU."""
    from rtk_tpu_torch.utils import aot

    tris = scenes.cornell_box()
    cfg = rtk_tpu_torch.BuildConfig(leaf_size=8)
    host = pack_scene(rtk_tpu_torch.build_from_soup(tris, config=cfg,
                                                    device="cpu"))
    odd = rtk_tpu_torch.jit_filter(lambda c: c.triangle_index % 2 == 1)
    packed = pack_scene(rtk_tpu_torch.build_from_soup(tris, config=cfg,
                                                      device=cuda))
    rays = scenes.cornell_camera(32, 32, device=cuda)
    for kw in ({"dual": True}, {"filter_fn": odd, "defer_uv": True}):
        lt = aot.load_packet_trace(aot.export_packet_trace(
            host, rays.count, platforms=["cuda"], **kw))
        assert lt.n_rays == 1024 and lt.platforms == ("cuda",)
        before = packet_trace.KERNEL_LAUNCHES
        got = lt(packed, rays)
        assert packet_trace.KERNEL_LAUNCHES == before + 1
        _assert_same(got, packet_trace.trace_packets(packed, rays, **kw))
        with pytest.raises(ValueError, match="exported for"):
            lt(host, scenes.cornell_camera(32, 32, device="cpu"))


def test_dispatch_probe_kernel(cuda):
    """tools/torch_profile_trace.py's dispatch probe on the card: built
    with the package's flags, bit-equal to its plain version on the card
    (x + 1.0) and value-equal to it on the CPU (the card's NaN may differ
    in its payload), on the seeded special values and a ragged size; each
    launch advances PROBE_LAUNCHES by one."""
    host = np.concatenate([ptrace.probe_input(s).reshape(-1)
                           for s in range(3)])
    for x in (host[:1024].reshape(ptrace.PROBE_SHAPE), host[:2567]):
        xt = torch.as_tensor(x, device=cuda)
        before = ptrace.PROBE_LAUNCHES
        got = ptrace.dispatch_probe(xt)
        torch.cuda.synchronize()
        assert ptrace.PROBE_LAUNCHES == before + 1
        assert got.shape == xt.shape and got.is_cuda
        assert torch.equal(got.view(torch.int32),
                           ptrace.dispatch_probe_reference(xt)
                           .view(torch.int32))
        np.testing.assert_array_equal(got.cpu().numpy(), x + np.float32(1))
    assert ptrace.BUILD_SECONDS is not None


def _key_batches():
    """Ray batches for the coherence key, made with numpy from a seed ->
    {name: (origin, direction)} on the CPU."""
    rng = np.random.default_rng(16)
    cam = scenes.camera_rays((0, 0, 3.0), (0, 0, 0), (0, 1, 0), 45, 64, 64,
                             order="morton", device="cpu")
    d = rng.normal(size=(300_000, 3)).astype(np.float32)
    o = (rng.normal(size=(300_000, 3)) * 3.0).astype(np.float32)
    d[::7] = 0.0  # zero directions: the norm's floor
    one = np.array([[0.5, -2.0, 3.0]], np.float32)
    return {"camera": (cam.origin, cam.direction),
            "scattered": (torch.from_numpy(o[:20000]),
                          torch.from_numpy(d[:20000])),
            # past the bounds kernels' grid (1024 blocks of 256 threads)
            "large": (torch.from_numpy(o), torch.from_numpy(d)),
            "same_origin": (torch.from_numpy(one).expand(5000, 3),
                            torch.from_numpy(d[:5000])),
            "same_ray": (torch.from_numpy(one).expand(40, 3),
                         torch.from_numpy(d[1:2]).expand(40, 3)),
            "single": (torch.from_numpy(one), torch.from_numpy(d[1:2]))}


def test_coherence_key_kernel(cuda):
    """ray_coherence_key on the card runs csrc/coherence_key.cu (one
    KEY_LAUNCHES a call) and equals the plain version on a CPU copy bit
    for bit: a camera (expanded origin), scattered origins, a batch past
    the bounds kernels' grid, the scale's and the extent's floors, one
    ray.  An empty batch launches nothing."""
    from rtk_tpu_torch.ops import morton

    for name, (o, d) in _key_batches().items():
        want = morton.ray_coherence_key_reference(o, d)
        before = packet_trace.KEY_LAUNCHES
        got = morton.ray_coherence_key(o.to(cuda), d.to(cuda))
        torch.cuda.synchronize()
        assert packet_trace.KEY_LAUNCHES == before + 1, name
        assert got.dtype == torch.int32 and got.is_cuda
        assert torch.equal(got.cpu(), want), (
            f"{name}: {int((got.cpu() != want).sum())} keys differ")
    empty = torch.zeros((0, 3), device=cuda)
    before = packet_trace.KEY_LAUNCHES
    assert morton.ray_coherence_key(empty, empty).shape == (0,)
    assert packet_trace.KEY_LAUNCHES == before


def test_sorted_trace_takes_the_key_from_the_library(cuda):
    """A sorted batch (sort_rays=True) through trace_packets and through a
    "cuda" AOT artifact launches the key's kernels, the rows pass and the
    unsort once each (the artifact from its embedded library) and equals
    the plain front end, which sorts by the plain key, gathers the stacked
    rows and unsorts by index-puts; with stats=True the unsort carries the
    counts too."""
    from rtk_tpu_torch.utils import aot

    tris = scenes.cornell_box()
    cfg = rtk_tpu_torch.BuildConfig(leaf_size=8)
    host = pack_scene(rtk_tpu_torch.build_from_soup(tris, config=cfg,
                                                    device="cpu"))
    packed = pack_scene(rtk_tpu_torch.build_from_soup(tris, config=cfg,
                                                      device=cuda))
    rays = scenes.cornell_camera(32, 32, device=cuda)
    lt = aot.load_packet_trace(aot.export_packet_trace(
        host, rays.count, platforms=["cuda"], sort_rays=True))
    want = packet_trace.trace_packets_reference(packed, rays, sort_rays=True)
    for call in (lambda: packet_trace.trace_packets(packed, rays,
                                                    sort_rays=True),
                 lambda: lt(packed, rays)):
        before = (packet_trace.KEY_LAUNCHES, packet_trace.ROWS_LAUNCHES,
                  packet_trace.UNSORT_LAUNCHES)
        got = call()
        torch.cuda.synchronize()
        assert (packet_trace.KEY_LAUNCHES, packet_trace.ROWS_LAUNCHES,
                packet_trace.UNSORT_LAUNCHES) == tuple(b + 1 for b in before)
        _assert_same(got, want)
    got, counts = packet_trace.trace_packets(packed, rays, sort_rays=True,
                                             stats=True)
    want, want_counts = packet_trace.trace_packets_reference(
        packed, rays, sort_rays=True, stats=True)
    _assert_same(got, want)
    assert torch.equal(counts, want_counts)


@pytest.mark.parametrize("n", [0, 1, 255, 257, 16384, 1 << 20])
def test_ray_rows_kernel(cuda, n):
    """The rows pass (csrc/ray_rows.cu, one ROWS_LAUNCHES a call, none for
    an empty batch) equals ray_rows_reference on CPU copies bit for bit,
    NaN payloads and signed zeros included, unsorted and through a seeded
    permutation: contiguous rays, an expanded origin (stride 0), a
    direction sliced from a wider tensor, and f64 rays."""
    rng = np.random.default_rng(n)
    vals = rng.normal(size=(n, 8)).astype(np.float32)
    special = rng.random((n, 8)) < 0.05
    vals[special] = rng.choice(np.array(
        [np.nan, -0.0, 0.0, np.inf, -np.inf, 1e-45], np.float32),
        int(special.sum()))
    rays = torch.from_numpy(vals).to(cuda)
    o, d, mn, mx = (rays[:, :3].contiguous(), rays[:, 3:6].contiguous(),
                    rays[:, 6].contiguous(), rays[:, 7].contiguous())
    wide = torch.full((n, 11), 7.0, device=cuda)
    wide[:, 4:7] = d
    eye = torch.tensor([0.5, -2.0, 3.0], device=cuda)
    layouts = {"contiguous": (o, d, mn, mx),
               "camera": (eye.as_strided((n, 3), (0, 1)), d, mn, mx),
               "sliced": (o, wide[:, 4:7], mn, mx),
               "f64": tuple(a.double() for a in (o, d, mn, mx))}
    assert layouts["camera"][0].stride() == (0, 1)
    assert layouts["sliced"][1].stride() == (11, 1)
    perm = torch.from_numpy(rng.permutation(n))
    for name, parts in layouts.items():
        for idx in (None, perm):
            before = packet_trace.ROWS_LAUNCHES
            got = packet_trace.ray_rows_kernel(
                *parts, None if idx is None else idx.to(cuda))
            torch.cuda.synchronize()
            assert packet_trace.ROWS_LAUNCHES == before + (n > 0), name
            want = packet_trace.ray_rows_reference(
                *(a.cpu() for a in parts), idx)
            assert got.is_cuda and got.dtype == torch.float32
            assert torch.equal(got.cpu().view(torch.int32),
                               want.view(torch.int32)), name


def test_trace_packets_launches_the_rows_pass_once(cuda):
    """Every trace_packets call on the card, sorted or not, writes its
    rows by exactly one rows pass and equals the plain front end, which
    launches none."""
    tris = scenes.cornell_box()
    packed = pack_scene(rtk_tpu_torch.build_from_soup(
        tris, config=rtk_tpu_torch.BuildConfig(leaf_size=8), device=cuda))
    rays = scenes.cornell_camera(48, 48, device=cuda)
    for sort in (False, True):
        before = packet_trace.ROWS_LAUNCHES
        want = packet_trace.trace_packets_reference(packed, rays,
                                                    sort_rays=sort)
        assert packet_trace.ROWS_LAUNCHES == before
        got = packet_trace.trace_packets(packed, rays, sort_rays=sort)
        torch.cuda.synchronize()
        assert packet_trace.ROWS_LAUNCHES == before + 1, sort
        _assert_same(got, want)


def test_sorted_call_spans_on_the_card(cuda):
    """A sorted call's steps on the card: the key, the sort, then the rows
    pass (no gather of stacked rows), the launch, the unsort, the wrap."""
    tris = scenes.cornell_box()
    packed = pack_scene(rtk_tpu_torch.build_from_soup(
        tris, config=rtk_tpu_torch.BuildConfig(leaf_size=8), device=cuda))
    rays = scenes.cornell_camera(32, 32, device=cuda)
    packet_trace.trace_packets(packed, rays, sort_rays=True)
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        packet_trace.trace_packets(packed, rays, sort_rays=True)
        torch.cuda.synchronize()
    steps = "rtk.packet_trace."
    assert [e.name[len(steps):] for e in prof.events()
            if e.name.startswith(steps)] == [
        "key", "sort", "rows", "launch", "unsort", "wrap"]


# ---- render_path's shade pass (csrc/shade.cu) ----

# The atrium as the path cell renders it: floor, ceiling (the light), 64
# columns and 4 walls as four meshes, a 1024^2 Morton camera.
ATRIUM_PARTS = (32768, 32768, 64 * 5120, 4 * 4096)
ATRIUM_CAM = dict(eye=(0, 6, 9), look_at=(0, 2, 0), up=(0, 1, 0),
                  fov_deg=60)
PATH_ALBEDO = [[0.7, 0.7, 0.7], [0.0, 0.0, 0.0], [0.6, 0.3, 0.3],
               [0.7, 0.7, 0.7]]
PATH_EMISSION = [[0, 0, 0], [4.0, 4.0, 4.0], [0, 0, 0], [0, 0, 0]]
PATH_BG = (0.2, 0.3, 0.4)


@pytest.fixture(scope="module")
def atrium_path():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    from rtk_tpu_torch.models import path

    dev = torch.device("cuda")
    atr = scenes.atrium()
    cuts = np.cumsum((0,) + ATRIUM_PARTS)
    scene = rtk_tpu_torch.build_scene(
        [_soup_of(atr[a:b]) for a, b in zip(cuts[:-1], cuts[1:])],
        rtk_tpu_torch.BuildConfig(leaf_size=16), device=dev)
    cam = scenes.camera_rays(**ATRIUM_CAM, width=1024, height=1024,
                             order="morton", device=dev)
    return dict(tracer=rtk_tpu_torch.Tracer(scene), cam=cam,
                mats=path.Materials.make(PATH_ALBEDO, PATH_EMISSION,
                                         device=dev),
                bg=torch.tensor(PATH_BG, device=dev),
                lo=scene.bounds_min, hi=scene.bounds_max,
                uniforms=torch.rand((4, cam.count, 2), device=dev,
                                    generator=torch.Generator(
                                        device=dev).manual_seed(5)))


def _bits(a):
    return a.view(torch.int32) if a.dtype == torch.float32 else a


@pytest.mark.parametrize("handed", [True, False])
@pytest.mark.parametrize("sort_rays", [True, False])
def test_shade_kernel_equals_plain_on_the_atrium(atrium_path, sort_rays,
                                                 handed):
    """The shade kernel against the eager plain pass on the card, on the
    primaries and all four bounce batches of a compacted 1024^2 atrium
    frame: the radiance, every field of the next rays, the throughput and
    the live count bit for bit, and its key sorts to the plain pass's
    permutation; dead rays and misses included.  Draws handed in by path,
    or a generator's (2, N) draw read by slot."""
    a = atrium_path
    _shade_frame(a["tracer"], a["cam"], a["mats"], a["bg"], a["lo"],
                 a["hi"], a["uniforms"], sort_rays=sort_rays, handed=handed)


def _shade_frame(tracer, cam, mats, bg, lo, hi, uniforms, *, sort_rays,
                 handed, bounces=4, record=lambda hits: None):
    """The shade kernel against the eager plain pass on every batch of a
    compacted frame of `bounces` bounces from `cam` through `tracer`:
    every output bit for bit, the key sorting to the plain permutation.
    record(hits) checks each bounce's record."""
    from rtk_tpu_torch.models import path

    n = cam.count
    dev = cam.device
    g = torch.Generator(device=dev).manual_seed(1)
    radiance = torch.zeros((n, 3), device=dev)
    throughput = torch.ones((n, 3), device=dev)
    index = torch.arange(n, device=dev)
    cur = cam
    kw = dict(epsilon=1e-4, sort_rays=sort_rays)
    for bounce in range(bounces + 1):
        hits = tracer.closest(cur)
        record(hits)
        last = bounce == bounces
        draws = draw_index = u1 = u2 = None
        if handed and not last:
            draws, draw_index = uniforms[bounce], index
            u1, u2 = uniforms[bounce, index].unbind(dim=1)
        elif not last:
            u = torch.rand((2, cur.count), generator=g, device=dev)
            draws, u1, u2 = u.T, u[0], u[1]
        before = path.SHADE_LAUNCHES
        got = path.shade_kernel(hits, cur, throughput, index,
                                radiance.clone(), mats, bg, lo, hi,
                                last=last, draws=draws,
                                draw_index=draw_index, **kw)
        assert path.SHADE_LAUNCHES == before + 1
        want = path._shade_sample(hits, cur, throughput, index, radiance,
                                  mats, None, bg, lo, hi, last=last, u1=u1,
                                  u2=u2, **kw)
        if last:
            assert torch.equal(_bits(got), _bits(want))
            break
        for g_, w_, what in zip(got, want, ("radiance", "rays",
                                            "throughput", "order",
                                            "alive")):
            if what == "rays":
                for f in ("origin", "direction", "min_t", "max_t"):
                    assert torch.equal(_bits(getattr(g_, f)),
                                       _bits(getattr(w_, f))), (bounce, f)
            elif what == "order":
                assert torch.equal(torch.sort(g_, stable=True).indices, w_)
            else:
                assert torch.equal(_bits(g_), _bits(w_)), (bounce, what)
        _, nxt, throughput, perm, alive = want
        assert 0 < int(alive) < cur.count
        m = min(cur.count, path._round_up_bucket(int(alive), 1024))
        cur, throughput, index = path._compact_take(nxt, throughput, index,
                                                    perm, m=m)


def test_render_path_through_the_shade_kernel(atrium_path, monkeypatch):
    """render_path with the uniforms handed in: the frame through the
    kernel equals the frame through the plain pass bit for bit; the
    kernel launches once a bounce (5 a frame) beside the loop's counters
    (5 traces of 1,048,576 rows, 4 host syncs)."""
    from rtk_tpu_torch.models import path

    a = atrium_path
    kw = dict(bounces=4, background=PATH_BG, uniforms=a["uniforms"])
    for c in ("SHADE_LAUNCHES", "PATH_TRACES", "PATH_ROWS", "PATH_SYNCS"):
        monkeypatch.setattr(path, c, 0)
    got = path.render_path(a["tracer"], a["cam"], a["mats"], **kw)
    torch.cuda.synchronize()
    assert (path.SHADE_LAUNCHES, path.PATH_TRACES, path.PATH_ROWS,
            path.PATH_SYNCS) == (5, 5, 5 * a["cam"].count, 4)
    monkeypatch.setattr(path, "_shade_card", path._shade_plain)
    want = path.render_path(a["tracer"], a["cam"], a["mats"], **kw)
    assert path.SHADE_LAUNCHES == 5
    assert torch.equal(_bits(got), _bits(want))
    assert float(got.amax()) > 1.0


@pytest.mark.parametrize("handed", [True, False])
def test_render_path_stackless_bounces_through_the_kernel(cuda, monkeypatch,
                                                          handed):
    """A stackless bounce_tracer gives plain Hits records (no slot): the
    kernel reads their own vertex positions, mesh indices and
    barycentrics, and the frame equals the plain pass's bit for bit."""
    from rtk_tpu_torch.models import path

    scene = rtk_tpu_torch.build_scene(_soup_of(scenes.cornell_box()),
                                      device=cuda)
    tracer = rtk_tpu_torch.Tracer(scene)
    records = []

    class Stackless(rtk_tpu_torch.Tracer):
        def closest(self, rays, **kw):
            hits = super().closest(rays, **kw)
            records.append(type(hits))
            return hits

    bounce_tracer = Stackless(scene, engine="stackless")
    rays = scenes.cornell_camera(64, 64, device=cuda)  # a closed box
    mats = path.Materials.make([[0.7, 0.6, 0.5]], [[0.1, 0.1, 0.1]],
                               device=cuda)
    kw = dict(bounces=3, background=PATH_BG)
    if handed:
        kw["uniforms"] = torch.rand((3, rays.count, 2), device=cuda)

    def frame():
        g = torch.Generator(device=cuda).manual_seed(2)
        return path.render_path(tracer, rays, mats, g,
                                bounce_tracer=bounce_tracer, **kw)

    monkeypatch.setattr(path, "SHADE_LAUNCHES", 0)
    got = frame()
    assert path.SHADE_LAUNCHES == 4
    assert records == [rtk_tpu_torch.Hits] * 3
    monkeypatch.setattr(path, "_shade_card", path._shade_plain)
    want = frame()
    assert torch.equal(_bits(got), _bits(want))
    assert float(got.amax()) > 0.2


@pytest.fixture
def instanced_path(cuda):
    """tests/test_torch_instanced_path.py's four rotated, unevenly scaled
    instances on the card, seen by 256^2 camera rays, with uniforms for 4
    bounces."""
    from test_torch_instanced_path import instanced_case

    c = instanced_case(device=cuda, side=256)
    c["uniforms"] = torch.rand((4, c["rays"].count, 2), device=cuda,
                               generator=torch.Generator(
                                   device=cuda).manual_seed(26))
    return c


@pytest.mark.parametrize("sort_rays", [True, False])
def test_shade_kernel_equals_plain_on_instanced_records(instanced_path,
                                                        sort_rays):
    """The shade kernel on instanced records (the normal mapped to world
    space by the hit instance's object_from_world) against the eager plain
    pass on the card, bit for bit on every output of every batch of a
    compacted 4-bounce frame over rotated, unevenly scaled instances."""
    c = instanced_path
    seen = []

    def record(hits):
        assert hits.instance is not None
        seen.append(set(hits.instance[hits.hit].tolist()))

    _shade_frame(c["tracer"], c["rays"], c["mats"],
                 torch.tensor(PATH_BG, device=c["rays"].device),
                 c["tracer"].scene.bounds_min, c["tracer"].scene.bounds_max,
                 c["uniforms"], sort_rays=sort_rays, handed=True,
                 record=record)
    assert len(seen) == 5 and len(seen[0]) == 4


def test_render_path_over_instances_through_the_shade_kernel(instanced_path,
                                                             monkeypatch):
    """render_path over an InstancedTracer on the card: the frame through
    the kernel equals the frame through the plain pass bit for bit; 5
    traces, each an instanced call whose launched rounds are the roots
    variant's launches."""
    from rtk_tpu_torch import instancing
    from rtk_tpu_torch.models import path

    c = instanced_path
    kw = dict(bounces=4, background=PATH_BG, epsilon=1e-3,
              uniforms=c["uniforms"])
    for name in ("SHADE_LAUNCHES", "INSTANCED_TRACES", "INSTANCED_ROUNDS"):
        monkeypatch.setattr(path if name.startswith("SHADE") else instancing,
                            name, 0)
    roots = packet_trace.ROOTS_LAUNCHES
    got = path.render_path(c["tracer"], c["rays"], c["mats"], **kw)
    torch.cuda.synchronize()
    assert path.SHADE_LAUNCHES == 5 and instancing.INSTANCED_TRACES == 5
    assert instancing.INSTANCED_ROUNDS == packet_trace.ROOTS_LAUNCHES - roots
    monkeypatch.setattr(path, "_shade_card", path._shade_plain)
    want = path.render_path(c["tracer"], c["rays"], c["mats"], **kw)
    assert torch.equal(_bits(got), _bits(want))
    assert float(got.amax()) > 0.2


def test_shade_kernel_refuses_a_cpu_tensor(atrium_path):
    """On CUDA tensors the wrapper launches or raises: a CPU tensor among
    the card's is refused before any launch."""
    from rtk_tpu_torch.models import path

    a = atrium_path
    cam = a["cam"][:4096]
    hits = a["tracer"].closest(cam)
    n = cam.count
    dev = cam.device
    before = path.SHADE_LAUNCHES
    with pytest.raises(ValueError, match="cpu"):
        path.shade_kernel(hits, cam, torch.ones((n, 3)),
                          torch.arange(n, device=dev),
                          torch.zeros((n, 3), device=dev), a["mats"],
                          a["bg"], a["lo"], a["hi"], epsilon=1e-4,
                          sort_rays=True, last=True)
    assert path.SHADE_LAUNCHES == before


# ---- the instance candidate slab: csrc/candidates.cu ----

def _on_grid(a, step=0.25):
    """Values rounded to a grid, so that entry distances tie."""
    return (np.round(np.asarray(a) / step) * step).astype(np.float32)


def candidate_case(name, device="cpu"):
    """Boxes and rays of one case of the candidate slab -> (lo, hi, Rays),
    f32 on `device`.  mixed: 60 boxes on a grid (ten of them repeated) and
    300 rays (not a whole block): origins inside boxes, aimed, axis-aligned
    with +-0.0 components and random directions, min_t of 0, 1e-3 and
    -inf, short and dead rows.  zero_dirs: origins on the boxes' planes,
    components of 0.0, -0.0 and +-1 (+0.0 and -0.0 distances), min_t of
    +-0.0.  ties: 14 equal boxes of 16 met by every ray; ties_wide: 40
    equal boxes of 50.  inside: nested boxes around the origins.
    dead_miss: dead rows and rays that miss every box.  one_ray, empty:
    batches of 1 and 0 rays."""
    rng = np.random.default_rng(sum(map(ord, name)))
    n_box, n = {"mixed": (60, 300), "zero_dirs": (24, 200),
                "ties": (16, 300), "ties_wide": (50, 100),
                "inside": (30, 200), "dead_miss": (20, 100),
                "one_ray": (20, 1), "empty": (20, 0)}[name]
    centre = _on_grid(rng.uniform(-4, 4, (n_box, 3)))
    half = _on_grid(rng.uniform(0.25, 1.5, (n_box, 3)))
    o = _on_grid(rng.uniform(-6, 6, (n, 3)))
    d = rng.normal(size=(n, 3)).astype(np.float32)
    min_t = np.zeros(n, np.float32)
    max_t = np.full(n, 3.4e38, np.float32)
    if name == "mixed":
        centre[40:50], half[40:50] = centre[10:20], half[10:20]
        o[:30] = centre[:30]
        d[:150] = centre[rng.integers(0, n_box, 150)] - o[:150]
        axis = np.zeros((75, 3), np.float32)
        axis[np.arange(75), rng.integers(0, 3, 75)] = rng.choice([-1, 1],
                                                                  75)
        axis[rng.random((75, 3)) < 0.3] *= -1  # -0.0 among the zeros
        d[150:225] = axis
        min_t[::7], min_t[::11] = 1e-3, -np.inf
        max_t[::5] = 4.0
        min_t[::13], max_t[::13] = 5.0, 1.0
    elif name == "zero_dirs":
        lo_, hi_ = centre - half, centre + half
        pick = rng.integers(0, n_box, n)
        on = rng.random((n, 3)) < 0.5
        o = np.where(on, np.where(rng.random((n, 3)) < 0.5, lo_[pick],
                                  hi_[pick]), o).astype(np.float32)
        d = rng.choice(np.array([0.0, -0.0, 1.0, -1.0, 0.5], np.float32),
                       (n, 3))
        min_t[rng.random(n) < 0.5] = -0.0
    elif name in ("ties", "ties_wide"):
        centre[:], half[:] = 0.0, 1.0
        odd = rng.choice(n_box, n_box // 8, replace=False)
        centre[odd, 0] = _on_grid(rng.uniform(-0.5, 0.5, odd.size))
        o = np.stack([np.full(n, -5.0), rng.uniform(-0.9, 0.9, n),
                      rng.uniform(-0.9, 0.9, n)], 1).astype(np.float32)
        d = np.tile(np.float32([1, 0, 0]), (n, 1))
        d[n // 2:] = [1.0, 0.125, -0.0]
    elif name == "inside":
        centre[:] = 0.0
        half = np.linspace(0.5, 8.0, n_box, dtype=np.float32)[:, None] \
            * np.float32([1, 1, 1])
        half[::4] = 0.25  # boxes the outer origins are not in
        o = _on_grid(rng.uniform(-0.4, 0.4, (n, 3)))
    elif name == "dead_miss":
        centre[:, 0] = np.abs(centre[:, 0]) + 2.0
        o[:, 0] = -1.0
        d[:, 0] = -np.abs(d[:, 0]) - 0.1
        min_t[::2], max_t[::2] = 2.0, 1.0
    ray = rtk_tpu_torch.Rays(*(torch.from_numpy(np.ascontiguousarray(a))
                               .to(device) for a in (o, d, min_t, max_t)))
    return (torch.from_numpy(centre - half).to(device),
            torch.from_numpy(centre + half).to(device), ray)


# (case, c): c = 1, 12, above K for one pass (c + 1 > 32 takes passes of
# 32), c = B and c > B, and every list length (K = 4, 8, 16, 32).
CANDIDATE_CASES = [("mixed", 1), ("mixed", 3), ("mixed", 12), ("mixed", 40),
                   ("mixed", 60), ("mixed", 75), ("zero_dirs", 4),
                   ("zero_dirs", 15), ("ties", 5), ("ties", 12),
                   ("ties", 20), ("ties_wide", 40), ("inside", 8),
                   ("dead_miss", 3), ("one_ray", 12), ("empty", 3)]


def assert_same_candidates(got, want, what):
    """cand_idx, cand_t and overflow equal bit for bit."""
    for g, w, name in zip(got, want, ("cand_idx", "cand_t", "overflow")):
        assert g.shape == w.shape, f"{what}: {name} shape"
        if g.dtype == torch.float32:
            g, w = g.view(torch.int32), w.view(torch.int32)
        assert torch.equal(g, w), f"{what}: {name}"


@pytest.mark.parametrize("name,c", CANDIDATE_CASES)
def test_candidates_kernel_equals_plain(cuda, name, c):
    """csrc/candidates.cu against _instance_candidates_impl on the same
    CUDA tensors, bit for bit: ties (the first instance wins), +-0.0
    components and distances, origins inside boxes, dead and missing rows,
    c from 1 to past B, the passes of a c + 1 above 32, ragged batches."""
    from rtk_tpu_torch import instancing

    lo, hi, rays = candidate_case(name, cuda)
    before = instancing.CANDIDATE_LAUNCHES
    got = instancing.candidates_kernel(lo, hi, rays, c)
    torch.cuda.synchronize()
    assert instancing.CANDIDATE_LAUNCHES == before + bool(rays.count)
    want = instancing._instance_candidates_impl(lo, hi, rays, c)
    assert_same_candidates(got, want, f"{name} c={c}")


def test_candidates_kernel_on_configuration_5(cuda):
    """Configuration 5's instance boxes (125 instances of blob(6) on the
    5^3 lattice) and its 1024^2 Morton primaries, C = 12: the kernel's
    three outputs equal the plain slab's bit for bit."""
    from rtk_tpu_torch import instancing

    blas = rtk_tpu_torch.build_from_soup(
        scenes.blob(6)[0], config=rtk_tpu_torch.BuildConfig(leaf_size=8),
        device=cuda)
    tf = np.zeros((125, 3, 4), np.float32)
    rng = np.random.default_rng(7)
    for i in range(125):
        tf[i, :, :3] = np.eye(3, dtype=np.float32) * (0.35
                                                      + 0.15 * rng.random())
        tf[i, :, 3] = (np.array([i % 5, i // 5 % 5, i // 25], np.float32)
                       * 1.1 + rng.random(3).astype(np.float32) * 0.2)
    iscene = rtk_tpu_torch.build_instanced([blas], np.zeros(125, np.int64),
                                           tf)
    rays = scenes.camera_rays((7.0, 6.5, 8.0), (2.2, 2.2, 2.2), (0, 1, 0),
                              55, 1024, 1024, order="morton", device=cuda)
    got = instancing._instance_candidates(iscene, rays, 12)
    want = instancing._instance_candidates_impl(iscene.inst_lo,
                                                iscene.inst_hi, rays, 12)
    assert_same_candidates(got, want, "configuration 5")
    live = got[0] >= 0
    assert bool(live[:, 0].any()) and bool(live[:, 11].any())


def test_instanced_trace_through_the_kernel_slab(cuda, monkeypatch):
    """trace_closest_instanced_packets through the kernel slab and through
    the plain slab give the same records and instance ids bit for bit,
    with and without the exactness residual's all-instance slab."""
    from rtk_tpu_torch import instancing
    from test_torch_instanced_path import instanced_case

    c = instanced_case(device=cuda, side=128)
    ps, rays = c["tracer"].pscene, c["rays"]

    def trace(k):
        st = {}
        hits, ids = instancing.trace_closest_instanced_packets(
            ps, rays, max_candidates=k, stats=st)
        return hits, ids, st["residual"]

    for k in (1, 2, 4):
        got = trace(k)
        with monkeypatch.context() as m:
            m.setattr(instancing, "candidates_kernel",
                      instancing._instance_candidates_impl)
            want = trace(k)
        _assert_same(got[0], want[0])
        assert torch.equal(got[1], want[1]) and got[2] == want[2]
        if k == 1:
            assert got[2] > 0  # the residual ran its all-instance slab


def test_candidate_launches_count_traces_and_residuals(cuda, monkeypatch):
    """CANDIDATE_LAUNCHES: one launch an instanced trace, and one more for
    a residual that re-traces rays (its slab over every instance); a
    render_path frame of 4 bounces launches it once a trace."""
    from rtk_tpu_torch import instancing
    from rtk_tpu_torch.models import path
    from test_torch_instanced_path import instanced_case

    c = instanced_case(device=cuda, side=128)
    ps, rays = c["tracer"].pscene, c["rays"]
    residuals = []
    real = instancing._residual_exhaustive
    monkeypatch.setattr(instancing, "_residual_exhaustive",
                        lambda *a: residuals.append(1) or real(*a))
    monkeypatch.setattr(instancing, "CANDIDATE_LAUNCHES", 0)
    instancing.trace_closest_instanced_packets(ps, rays, max_candidates=4,
                                               exact=False)
    assert instancing.CANDIDATE_LAUNCHES == 1 and not residuals
    st = {}
    instancing.trace_closest_instanced_packets(ps, rays, max_candidates=1,
                                               stats=st)
    assert st["residual"] > 0 and len(residuals) == 1
    assert instancing.CANDIDATE_LAUNCHES == 3
    for name in ("CANDIDATE_LAUNCHES", "INSTANCED_TRACES"):
        monkeypatch.setattr(instancing, name, 0)
    residuals.clear()
    uniforms = torch.rand((4, rays.count, 2), device=cuda,
                          generator=torch.Generator(
                              device=cuda).manual_seed(27))
    path.render_path(c["tracer"], rays, c["mats"], bounces=4,
                     background=PATH_BG, epsilon=1e-3, uniforms=uniforms)
    torch.cuda.synchronize()
    assert instancing.INSTANCED_TRACES == 5
    assert instancing.CANDIDATE_LAUNCHES == 5 + len(residuals)



@contextlib.contextmanager
def _host_syncs(monkeypatch):
    """Counts torch's host sync warnings inside the block, as
    chip_smoke.py::host_syncs does, and apart those made inside the stack
    engine's loops (the instanced residual's) -> (a function giving the
    count so far, the list of each loop's count)."""
    from rtk_tpu_torch.trace import stack

    loops = []
    real_loop = stack._trace_loop
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")

            def count():
                return sum("synchroniz" in str(w.message) for w in caught)

            def loop(*a, **kw):
                before = count()
                out = real_loop(*a, **kw)
                loops.append(count() - before)
                return out

            monkeypatch.setattr(stack, "_trace_loop", loop)
            yield count, loops
    finally:
        torch.cuda.set_sync_debug_mode("default")
        monkeypatch.setattr(stack, "_trace_loop", real_loop)


def test_instanced_frame_syncs_equal_the_counters(instanced_path,
                                                  monkeypatch):
    """One instanced render_path frame (4 bounces, 2 candidates a ray, so
    the residual re-traces rays on the stack engine): torch's count of
    host syncs equals the syncs INSTANCED_SYNCS and PATH_SYNCS count,
    beside those the stack engine's steps make in the residual and one
    more: render_path copies its background to the card (types._f32).
    It holds on the card's route, where a launched round syncs once (its
    live count; csrc/rounds.cu's scatter none), and through the rounds'
    eager glue, which syncs six times more a launched round."""
    from rtk_tpu_torch import instancing
    from rtk_tpu_torch.models import path

    c = instanced_path
    kw = dict(bounces=4, background=PATH_BG, epsilon=1e-3,
              uniforms=c["uniforms"])

    def counted_frame():
        path.render_path(c["tracer"], c["rays"], c["mats"], **kw)
        for name in ("INSTANCED_SYNCS", "INSTANCED_RESIDUAL",
                     "INSTANCED_ROUNDS"):
            monkeypatch.setattr(instancing, name, 0)
        monkeypatch.setattr(path, "PATH_SYNCS", 0)
        with _host_syncs(monkeypatch) as (count, loops):
            path.render_path(c["tracer"], c["rays"], c["mats"], **kw)
            total = count()
        assert instancing.INSTANCED_RESIDUAL > 0 and loops
        assert path.PATH_SYNCS == 4
        assert total == (instancing.INSTANCED_SYNCS + path.PATH_SYNCS
                         + sum(loops) + 1)
        return instancing.INSTANCED_SYNCS, instancing.INSTANCED_ROUNDS

    card = counted_frame()
    monkeypatch.setattr(instancing, "round_rays_kernel",
                        instancing.round_rays_reference)
    monkeypatch.setattr(instancing, "round_scatter_kernel",
                        instancing.round_scatter_reference)
    eager = counted_frame()
    assert card[1] == eager[1] > 0
    assert eager[0] - card[0] == 6 * card[1]


@pytest.mark.parametrize("caps", ["auto", "starved"])
def test_instanced_capped_trace_syncs_equal_the_counter(instanced_path,
                                                        monkeypatch, caps):
    """An instanced trace with round caps on the card: torch's count of
    host syncs equals INSTANCED_SYNCS (each round's live count; the auto
    caps' tolist; in a round a cap cuts, bincount's two reads, the cut's
    three masks and True copied to the card; the rounds' kernels none)
    beside the syncs of the residual's stack engine."""
    from rtk_tpu_torch import instancing

    c = instanced_path
    ps, rays = c["pscene"], c["rays"]
    n_c = c["tracer"].max_candidates
    kw = dict(max_candidates=n_c,
              round_caps=caps if caps == "auto" else (128,) * n_c)
    instancing.trace_closest_instanced_packets(ps, rays, **kw)
    monkeypatch.setattr(instancing, "INSTANCED_SYNCS", 0)
    with _host_syncs(monkeypatch) as (count, loops):
        instancing.trace_closest_instanced_packets(ps, rays, **kw)
        total = count()
    assert total == instancing.INSTANCED_SYNCS + sum(loops)


def test_sorted_closest_call_makes_no_sync(cuda, monkeypatch):
    """A sorted Tracer.closest call and its six field reads, as a
    closest-hit user makes them: no host sync, so that one CUDA graph can
    hold the call."""
    v, f = scenes.blob(4)[1:]
    tracer = rtk_tpu_torch.Tracer(rtk_tpu_torch.build_scene((v, f),
                                                            device=cuda))
    rays = scenes.camera_rays((0, 0, 3.0), (0, 0, 0), (0, 1, 0), 45, 128,
                              128, device=cuda)
    assert rays.count >= packet_trace.SORT_RAYS_MIN

    def call():
        h = tracer.closest(rays)
        return [getattr(h, k) for k in ("hit", "t", "u", "v",
                                         "triangle_index", "mesh_index")]

    call()
    with _host_syncs(monkeypatch) as (count, _):
        call()
        assert count() == 0


# ---- an instanced round's object rays and scatter: csrc/rounds.cu ----

# (affines, rows): uniform scales, rotations with uneven scales, a negative
# scale, a round whose rows are all of one instance; 0, 1, 31, 33 rows (a
# warp and a block each side) and 391 (not a whole block).
ROUND_CASES = [("uniform", 0), ("uniform", 1), ("uniform", 31),
               ("rotation", 33), ("negative", 391), ("one_instance", 33),
               ("rotation", 391)]


def round_case(affines, m, device="cpu"):
    """Inputs of a candidate round's object rays (round_rays_reference's
    arguments) -> tuple, on `device`: m distinct rows of a frame of 2m + 5
    rays grouped by instance as a round sorts them; origins and directions
    with +-0.0 components, min t of 0, 1e-3 and -inf, best t finite and
    RTK_INF; 9 instances (one for one_instance) of 3 BLAS."""
    from rtk_tpu_torch.instancing import _affine_inverse
    from rtk_tpu_torch.types import RTK_INF
    from test_torch_instanced_path import _rotation

    rng = np.random.default_rng(m * 7 + sum(map(ord, affines)))
    n, n_inst = 2 * m + 5, 1 if affines == "one_instance" else 9
    tf = np.zeros((n_inst, 3, 4))
    for i in range(n_inst):
        scale = rng.uniform(0.2, 3.0, 3)
        if affines == "uniform":
            lin = np.eye(3) * scale[0]
        elif affines == "negative":
            lin = np.diag(scale * np.where(np.arange(3) == i % 3, -1, 1))
        else:
            lin = _rotation(rng.normal(size=3),
                            rng.uniform(0, 2 * np.pi)) @ np.diag(scale)
        tf[i, :, :3], tf[i, :, 3] = lin, rng.uniform(-8, 8, 3)
    ofw = np.stack([_affine_inverse(a) for a in tf]).astype(np.float32)
    rows = rng.permutation(n)[:m]
    inst = rng.integers(0, n_inst, m)
    order = np.argsort(inst, kind="stable")
    o = rng.normal(size=(n, 3)).astype(np.float32) * 5
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[rng.random((n, 3)) < 0.1] = 0.0
    d[rng.random((n, 3)) < 0.1] = -0.0
    o[rng.random((n, 3)) < 0.05] = -0.0
    min_t = rng.choice(np.float32([0.0, 1e-3, -np.inf]), n)
    best_t = rng.uniform(0.5, 40, n).astype(np.float32)
    best_t[rng.random(n) < 0.3] = RTK_INF

    def on(a, dtype=None):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device, dtype)

    return (on(rows[order], torch.int64), on(inst[order], torch.int64),
            on(o), on(d), on(min_t), on(best_t), on(ofw),
            on(rng.integers(0, 3, n_inst), torch.int32),
            on(rng.integers(0, 5000, 3), torch.int32))


def assert_same_round_rays(got, want, what):
    """round_rays_kernel's (Rays, roots, inst) against the plain version's,
    bit for bit (the instances as i32)."""
    (g_rays, g_roots, g_inst), (w_rays, w_roots, w_inst) = got, want
    for name in ("origin", "direction", "min_t", "max_t"):
        g, w = getattr(g_rays, name), getattr(w_rays, name)
        assert g.shape == w.shape, f"{what}: {name} shape"
        assert torch.equal(g.view(torch.int32), w.view(torch.int32)), \
            f"{what}: {name}"
    assert g_roots.dtype == w_roots.dtype == torch.int32
    assert torch.equal(g_roots, w_roots), f"{what}: roots"
    assert g_inst.dtype == torch.int32
    assert torch.equal(g_inst, w_inst.to(torch.int32)), f"{what}: inst"


# (case, rows): hits that improve, misses, ties with best t, NaN t; a
# round where no row improves; 0, 1, 33 and 391 rows.
SCATTER_CASES = [("mixed", 0), ("mixed", 1), ("mixed", 33), ("mixed", 391),
                 ("none", 33), ("ties", 391)]


def scatter_case(name, m, device="cpu"):
    """Inputs of a candidate round's scatter (round_scatter_kernel's
    arguments but best) and the frame's best records -> (args, best), on
    `device`: m distinct rows of a frame of 2m + 5 rays, bt each row's
    best t; mixed: hit or not, t below, equal to and above bt, NaN t, u
    and v of +-0.0; none: no hit is below bt (equal, above, or no hit);
    ties: every hit's t equals bt but a few."""
    rng = np.random.default_rng(m * 5 + sum(map(ord, name)))
    n = 2 * m + 5
    rows = rng.permutation(n)[:m]
    best_t = rng.uniform(0.5, 40, n).astype(np.float32)
    bt = best_t[rows]
    hit = rng.random(m) < 0.7
    pick = rng.integers(0, 4, m)
    t = np.where(pick == 0, bt * np.float32(0.5),
                 np.where(pick == 1, bt, bt + np.float32(1.0)))
    t = np.where(pick == 3, np.float32(np.nan), t).astype(np.float32)
    if name == "none":
        t = np.where(t < bt, bt, t).astype(np.float32)
    elif name == "ties":
        t = bt.copy()
        t[::17] = bt[::17] * np.float32(0.25)
    uv = rng.uniform(0, 1, (2, m)).astype(np.float32)
    uv[rng.random((2, m)) < 0.1] = -0.0

    def on(a, dtype=None):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device, dtype)

    args = (on(rows, torch.int64), on(hit), on(t), on(uv[0]), on(uv[1]),
            on(rng.integers(-1, 9000, m), torch.int32), on(bt),
            on(rng.integers(0, 125, m), torch.int32))
    best = {"t": on(best_t), "u": on(rng.uniform(0, 1, n).astype(np.float32)),
            "v": on(rng.uniform(0, 1, n).astype(np.float32)),
            "slot": on(rng.integers(-1, 9000, n), torch.int32),
            "inst": on(rng.integers(-1, 125, n), torch.int32)}
    return args, best


def assert_same_best(got, want, what):
    """The frame's best records, bit for bit."""
    for k in ("t", "u", "v", "slot", "inst"):
        g, w = got[k], want[k]
        if g.dtype == torch.float32:
            g, w = g.view(torch.int32), w.view(torch.int32)
        assert torch.equal(g, w), f"{what}: best[{k!r}]"


@pytest.mark.parametrize("affines,m", ROUND_CASES + [
    ("rotation", 1_048_577), ("negative", 1_048_577)])
def test_round_rays_kernel_equals_plain(cuda, affines, m):
    """csrc/rounds.cu's round rays against round_rays_reference
    (_object_rays and the eager gathers) on the same CUDA tensors, bit for
    bit: uniform scales, rotations, negative scales, one instance; 0 to
    1,048,577 rows; one launch a round with rows."""
    from rtk_tpu_torch import instancing

    args = round_case(affines, m, cuda)
    before = instancing.ROUND_LAUNCHES
    got = instancing.round_rays_kernel(*args)
    torch.cuda.synchronize()
    assert instancing.ROUND_LAUNCHES == before + bool(m)
    assert_same_round_rays(got, instancing.round_rays_reference(*args),
                           f"{affines} m={m}")


@pytest.mark.parametrize("name,m", SCATTER_CASES + [("mixed", 1_048_577)])
def test_round_scatter_kernel_equals_plain(cuda, name, m):
    """csrc/rounds.cu's scatter against round_scatter_reference (the
    masked index-puts) on the same CUDA tensors: the frame's best records
    bit for bit afterwards, with misses, ties with best t, NaN t and a
    round where no row improves; one launch a round with rows."""
    from rtk_tpu_torch import instancing

    args, best = scatter_case(name, m, cuda)
    want = {k: v.clone() for k, v in best.items()}
    before = instancing.ROUND_LAUNCHES
    instancing.round_scatter_kernel(*args, best)
    torch.cuda.synchronize()
    assert instancing.ROUND_LAUNCHES == before + bool(m)
    instancing.round_scatter_reference(*args, want)
    assert_same_best(best, want, f"{name} m={m}")
    if name == "none":
        assert_same_best(best, scatter_case(name, m, cuda)[1], "unchanged")


def _round_scene(device):
    """16 instances of two BLAS (blob(2) and a box): uniform scales,
    rotations with uneven scales and negative scales, spread so that rays
    meet several boxes, and 128^2 Morton camera rays that see them."""
    from test_torch_instanced_path import _rotation

    rng = np.random.default_rng(30)
    blas = [rtk_tpu_torch.build_scene(_soup_of(t), device=device)
            for t in (scenes.blob(2)[0],
                      scenes.box([-0.5, -0.5, -0.5], [0.5, 0.5, 0.5]))]
    tf = np.zeros((16, 3, 4), np.float32)
    for i in range(16):
        scale = rng.uniform(0.3, 0.9, 3)
        lin = (np.eye(3) * scale[0] if i % 3 == 0 else
               np.diag(-scale) if i % 3 == 1 else
               _rotation(rng.normal(size=3), rng.uniform(0, 6)) @ np.diag(
                   scale))
        tf[i, :, :3], tf[i, :, 3] = lin, rng.uniform(-3, 3, 3)
    pscene = rtk_tpu_torch.pack_instanced(rtk_tpu_torch.build_instanced(
        blas, rng.integers(0, 2, 16), tf))
    rays = scenes.camera_rays((0, 1.5, 9), (0, 0, 0), (0, 1, 0), 50, 128,
                              128, order="morton", device=device)
    return pscene, rays


@pytest.mark.parametrize("caps", [None, "auto", "starved"])
@pytest.mark.parametrize("c", [1, 2, 12])
def test_instanced_rounds_kernel_route_equals_plain(cuda, c, caps):
    """trace_closest_instanced_packets on the card through the rounds'
    kernels against plain=True (the eager glue and the plain traversal)
    on the same CUDA tensors: t, u, v, slot, hit and instance bit for bit,
    at C = 1, 2 and 12, uncapped, with auto caps and with starved caps;
    ROUND_LAUNCHES two a launched round on the kernel route, none on the
    plain one."""
    from rtk_tpu_torch import instancing

    pscene, rays = _round_scene(cuda)
    kw = dict(max_candidates=c,
              round_caps=(128,) * c if caps == "starved" else caps)
    launches, rounds = instancing.ROUND_LAUNCHES, instancing.INSTANCED_ROUNDS
    st = {}
    got = instancing.trace_closest_instanced_packets(pscene, rays, stats=st,
                                                     **kw)
    torch.cuda.synchronize()
    rounds = instancing.INSTANCED_ROUNDS - rounds
    assert rounds == sum(k > 0 for k in st["live_counts"]) > 0
    assert instancing.ROUND_LAUNCHES - launches == 2 * rounds
    launches = instancing.ROUND_LAUNCHES
    want = instancing.trace_closest_instanced_packets(pscene, rays,
                                                      plain=True, **kw)
    assert instancing.ROUND_LAUNCHES == launches
    _assert_same(got[0], want[0])
    assert torch.equal(got[1], want[1])
    assert int(got[0].hit.sum()) > rays.count // 8
    if caps == "starved":
        assert st["residual"] > 0

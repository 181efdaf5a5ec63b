"""16-wide node tables (the kernel's w_arity=16 variant) in the port against
rtk_tpu: the tables of pack_binary_tree(branching=16) bit for bit, their
depth and roots against a walk that does not read the masks, the plain
traversal against rtk_tpu's Pallas kernel (interpret mode) and against
the port's own 8-wide tables, and blobs both ways."""
import io

import numpy as np
import pytest
import torch

import rtk_tpu
from rtk_tpu.ops.pallas_trace import trace_packets as jax_trace_packets
from rtk_tpu.testing import scenes as jax_scenes
from rtk_tpu.trace import packed as jpacked
from rtk_tpu.utils import serialize as jser
from rtk_tpu_torch.ops import packet_trace
from rtk_tpu_torch.ops.packet_trace import trace_packets
from rtk_tpu_torch.testing import scenes
from rtk_tpu_torch.trace import packed as tpacked
from rtk_tpu_torch.utils import serialize as tser
from rtk_tpu_torch.utils.native_sah import NativeOracle

from test_torch_kernel import chain_forest
from test_torch_packed import assert_tables_equal
from test_torch_trace import CPU, _check, _rays

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def tables():
    """blob(3) (1,280 triangles) under the step-quantized SAH with leaf 16,
    packed 8- and 16-wide by both packages from one exported tree."""
    tris = scenes.blob(3)[0]
    tree = NativeOracle(tris.reshape(-1, 9), leaf_max=16,
                        step_quant=True).export_tree()
    mask = (np.arange(tris.shape[0]) % 3 + 1).astype(np.uint32)
    out = {}
    for w in (8, 16):
        kw = dict(leaf_size=16, branching=w, tri_mask=mask)
        out[w] = (jpacked.pack_binary_tree(tris, *tree, **kw),
                  tpacked.pack_binary_tree(tris, *tree, **kw, device=CPU))
    return out


def _incoherent(n=600, seed=4):
    rng = np.random.default_rng(seed)
    return rtk_tpu.Rays.make((rng.normal(size=(n, 3)) * 2).astype(np.float32),
                             rng.normal(size=(n, 3)).astype(np.float32))


def _walk_depth(slot_src, root_rows, root):
    """Levels of the tree at `root`, read from slot_src alone: the j-th
    internal slot of the table (row-major) is row root_rows + j."""
    child_row = np.cumsum(slot_src.reshape(-1) >= 0).reshape(
        slot_src.shape) - 1 + root_rows
    kids = child_row[root][slot_src[root] >= 0]
    return 1 + max((_walk_depth(slot_src, root_rows, int(c)) for c in kids),
                   default=0)


def test_w16_tables_equal_rtk_tpu(tables):
    j16, t16 = tables[16]
    assert_tables_equal(t16, j16)
    assert t16.nodes.shape == (t16.num_nodes * 16, 8)
    # The masks word: internal children in bits 0-15, leaves in 16-31.
    masks = t16.meta[:, 2].numpy().astype(np.int64) & 0xFFFFFFFF
    slots = t16.slot_src.numpy()
    bits = 1 << np.arange(16)
    np.testing.assert_array_equal(masks & 0xFFFF,
                                  ((slots >= 0) * bits).sum(1))
    np.testing.assert_array_equal(masks >> 16, ((slots <= -2) * bits).sum(1))
    assert (slots[:, 8:] >= 0).any()  # children past slot 8 are counted


def test_w16_depth_and_roots_against_a_walk(tables):
    """depth and table_roots read 16-bit internal masks; an 8-bit read
    drops children 8-15 and undercounts."""
    _, t16 = tables[16]
    meta, slots = t16.meta.numpy(), t16.slot_src.numpy()
    want = _walk_depth(slots, 1, 0)
    assert t16.depth == tpacked.tree_depth(meta, w=16) == want
    assert t16.stack_size == 1 + 15 * want
    np.testing.assert_array_equal(tpacked.table_roots(meta, 16), [0])
    assert len(tpacked.table_roots(meta, 8)) > 1
    # A forest whose second tree is a chain of 400 nodes: 16-wide rows
    # take 15 links each, so the depth crosses the kernel's 256-entry
    # stack (17 levels), and the wrapper refuses before launch.
    tri_v, *tree, roots = chain_forest(400)
    forest = tpacked.pack_binary_tree(tri_v, *tree, roots, leaf_size=1,
                                      branching=16, device=CPU)
    slots = forest.slot_src.numpy()
    per_root = [_walk_depth(slots, 2, r) for r in (0, 1)]
    assert per_root[1] > per_root[0]
    assert forest.depth == max(per_root) == tpacked.tree_depth(
        forest.meta.numpy(), w=16)
    np.testing.assert_array_equal(
        tpacked.table_roots(forest.meta.numpy(), 16), [0, 1])
    assert forest.stack_size > 256
    jforest = jpacked.pack_binary_tree(tri_v, *tree, roots, leaf_size=1,
                                       branching=16)
    assert_tables_equal(forest, jforest)


@pytest.mark.parametrize("mode", ["closest", "any"])
def test_w16_plain_matches_rtk_tpu(tables, mode):
    """The port's plain traversal of the 16-wide tables against rtk_tpu's
    kernel on the same tables in interpret mode (test_packet.py's bar for
    closest; equal hit masks for any-hit, whose t depends on the order)."""
    j16, t16 = tables[16]
    for jrays in (jax_scenes.camera_rays((0, 0, 3.0), (0, 0, 0), (0, 1, 0),
                                         45, 24, 24),
                  _incoherent(256)):
        want = jax_trace_packets(j16, jrays, mode=mode, interpret=True,
                                 sort_rays=False)
        got = trace_packets(t16, _rays(jrays), mode=mode)
        if mode == "closest":
            _check(got, want)
        else:
            np.testing.assert_array_equal(got.hit.numpy(),
                                          np.asarray(want.hit))


def test_w16_matches_w8_in_the_port(tables):
    """Both widths in the port: equal hit masks, t within 1e-6*(1+|t|),
    the same triangle except at exact-t ties; mask filter and any-hit
    too.  Counts: steps = internal + leaf pops, and an any-hit ray pops
    no more than its closest-hit trace."""
    (_, t8), (_, t16) = tables[8], tables[16]
    cam = scenes.camera_rays((0, 0, 3.0), (0, 0, 0), (0, 1, 0), 45, 32, 32,
                             order="morton", device=CPU)
    for rays in (cam, _rays(_incoherent())):
        for kw in (dict(), dict(filter_mask=2), dict(defer_uv=True)):
            a, b = trace_packets(t8, rays, **kw), trace_packets(t16, rays,
                                                                **kw)
            assert torch.equal(a.hit, b.hit)
            assert bool(((a.t - b.t).abs() <= 1e-6 * (1 + a.t.abs())).all())
            tie = a.triangle_index != b.triangle_index
            assert torch.equal(a.t[tie], b.t[tie])
        a = trace_packets(t8, rays, mode="any")
        assert torch.equal(a.hit, trace_packets(t16, rays, mode="any").hit)
        (_, closest), (_, anyhit) = (trace_packets(t16, rays, mode=m,
                                                   stats=True)
                                     for m in ("closest", "any"))
        assert torch.equal(closest[0], closest[1] + closest[2])
        assert bool((anyhit <= closest).all())


def test_w16_blob_both_ways(tables):
    """The port's blob of 16-wide tables is rtk_tpu's bytes; each package
    loads the other's as 16-wide tables that trace the same."""
    j16, t16 = tables[16]

    def blob(save, obj):
        buf = io.BytesIO()
        save(obj, buf)
        return buf.getvalue()

    mine, theirs = (blob(tser.save_packed_scene, t16),
                    blob(jser.save_packed_scene, j16))
    assert mine == theirs
    back = jser.load_packed_scene(mine)
    assert back.branching == 16
    loaded = tser.load_any(theirs, device=CPU)
    assert (loaded.branching, loaded.depth) == (16, t16.depth)
    assert_tables_equal(loaded, back)
    rays = scenes.camera_rays((0, 0, 3.0), (0, 0, 0), (0, 1, 0), 45, 16, 16,
                              device=CPU)
    a, b = trace_packets(t16, rays), trace_packets(loaded, rays)
    for f in ("hit", "t", "u", "v", "slot"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f


def test_widths_other_than_8_and_16_are_refused(tables):
    _, t16 = tables[16]
    rays8 = torch.zeros((8, 4))
    with pytest.raises(ValueError, match="8 or 16"):
        packet_trace.packet_trace_reference(
            t16.nodes, t16.tris, rays8, leaf_size=16, stack_size=31,
            branching=12)
    with pytest.raises(ValueError, match="16"):  # a 16-row stride
        packet_trace.packet_trace_reference(
            t16.nodes[:-8], t16.tris, rays8, leaf_size=16, stack_size=31,
            branching=16)
    tri_v, *tree, roots = chain_forest(8)
    with pytest.raises(ValueError, match="branching"):
        tpacked.pack_binary_tree(tri_v, *tree, roots, leaf_size=1,
                                 branching=4, device=CPU)

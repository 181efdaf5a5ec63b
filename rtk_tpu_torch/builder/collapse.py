"""Collapse the binary LBVH into a wide (BVH4/BVH8) SoA node array.

rtk collapses its binary build tree into BVH4 by taking grandchildren two
levels at a time (rtk.c:1570-1622); this takes log2(W) levels for every
node at once:

  * a binary internal node owns the wide row of the same index;
  * its wide children are all binary descendants log2(W) levels below
    (leaves met earlier become direct children);
  * empty slots get inverted bounds (+1/-1) so any slab test fails, like
    rtk's empty BVH4 slots (rtk.c:1612-1620).
"""
from __future__ import annotations

import torch

from rtk_tpu_torch.builder.lbvh import is_leaf_code, leaf_id_of

EMPTY = -1


def collapse_wide(left, right, node_min, node_max, leaf_min, leaf_max,
                  branching: int):
    """Build wide SoA nodes from the binary topology.

    Args:
      left/right: (Li,) binary child arrays (shared encoding).
      node_min/node_max: (Li, 3) refit binary bounds.
      leaf_min/leaf_max: (L, 3) leaf bounds.
      branching: W in {2, 4, 8}.

    Returns:
      wide_child: (Li, W) i32: >= 0 wide node index (== binary id), -1
        empty, <= -2 leaf.  Doubles as the refit source encoding.
      wide_min/wide_max: (Li, W, 3) f32 child bounds.
    """
    k = {2: 1, 4: 2, 8: 3}[branching]
    n_int = left.shape[0]
    left = left.to(torch.int64)
    right = right.to(torch.int64)
    slots = [left, right]
    for _ in range(k - 1):
        nxt = []
        for s in slots:
            internal = s >= 0
            si = s.clamp(0, n_int - 1)
            nxt.append(torch.where(internal, left[si], s))
            nxt.append(torch.where(internal, right[si], EMPTY))
        slots = nxt
    src = torch.stack(slots, dim=1)  # (Li, W) binary ids / leaf codes / EMPTY
    wide_min, wide_max = gather_slot_bounds(src, node_min, node_max,
                                            leaf_min, leaf_max)
    return src.to(torch.int32), wide_min, wide_max


def gather_slot_bounds(src, node_min, node_max, leaf_min, leaf_max):
    """Child-slot AABBs from binary-tree sources; empty slots get the
    inverted sentinel bounds (min=+1, max=-1), rtk.c:1612-1620."""
    n_int = node_min.shape[0]
    n_leaf = leaf_min.shape[0]
    sentinel = torch.tensor([[1.0, 1.0, 1.0, -1.0, -1.0, -1.0]],
                            dtype=node_min.dtype, device=node_min.device)
    table = torch.cat([torch.cat([node_min, node_max], dim=1),
                       torch.cat([leaf_min, leaf_max], dim=1), sentinel])
    src = src.to(torch.int64)
    li = leaf_id_of(src).clamp(0, n_leaf - 1)
    rows = torch.where(src >= 0, src,
                       torch.where(is_leaf_code(src), n_int + li,
                                   n_int + n_leaf))
    g = table[rows]  # (Li, W, 6)
    return g[..., :3], g[..., 3:]

"""LBVH topology from sorted Morton codes (Karras 2012), on the device.

Numbering: L leaves (Morton-sorted triangle clusters), L-1 internal nodes.
Internal node i covers a contiguous range of sorted leaves; node 0 is the
root.  Child encoding (shared with traversal):
    >= 0 : internal node index
    == -1: empty slot
    <= -2: leaf, id = -(child) - 2

The topology is bit-equal to rtk_tpu.builder.lbvh.karras_topology_scan,
including its lexicographic (delta, position) tie rule.  Codes come in as
int32 (30-bit Morton codes) or int64 (custom keys that use all 32 bits)
and are widened to int64 here; PyTorch has no count-leading-zeros, so
`clz32` derives it from the float64 exponent (exact below 2^53).
"""
from __future__ import annotations

import math

import torch

EMPTY = -1
# Levels of the range table that the last refit_ranges_flat built (a build,
# or a refit by the plain version, scene.refit_reference): each level above
# the first enqueues two cats, a minimum and a maximum, so the plain
# refit's eager op count grows with it.  The card's refit
# (scene.refit_kernel) builds no table and leaves it as it is, so after a
# build on the card and refits there it reads the build's levels.
REFIT_LEVELS = 0


def leaf_code(leaf_id):
    return -leaf_id - 2


def is_leaf_code(child):
    return child <= -2


def leaf_id_of(child):
    return -child - 2


def clz32(x: torch.Tensor) -> torch.Tensor:
    """Leading zeros of each value as a 32-bit word (x in [0, 2^32))."""
    _, e = torch.frexp(x.to(torch.float64))  # x = m * 2^e, m in [0.5, 1)
    return 32 - e.to(torch.int64)  # frexp(0) gives e = 0 -> 32


def _aug_delta(codes: torch.Tensor) -> torch.Tensor:
    """Adjacent-pair common-prefix lengths of augmented (code, index) keys.

    A[k] = delta(k, k+1) in Karras terms: clz of the code xor, falling
    back to 32 + clz(index xor) for duplicate codes (total order).
    """
    n = codes.shape[0] - 1
    x = codes[:-1] ^ codes[1:]
    k = torch.arange(n, dtype=torch.int64, device=codes.device)
    di = 32 + clz32(k ^ (k + 1))
    return torch.where(x == 0, di, clz32(x))


_A_MAX = 64  # augmented deltas live in [0, 63]


def karras_topology_scan(codes: torch.Tensor):
    """Binary radix-tree topology over L >= 2 sorted Morton codes.

    The Cartesian tree of the adjacent-delta array A under the
    lexicographic (delta, position) rule: node = split position s; its
    leaf range comes from the nearest smaller values of A on either side
    (one masked running max/min per delta value); its parent is the
    deeper of its two boundary splits.  Returns (left, right, lo, hi),
    each (L-1,) int32, with node 0 the root.
    """
    length = codes.shape[0]
    assert length >= 2
    dev = codes.device
    ns = length - 1
    A = _aug_delta(codes.to(torch.int64))
    iota = torch.arange(ns, dtype=torch.int64, device=dev)

    # Left: last j < s with A[j] <= A[s], else -1.  Right: first j > s with
    # A[j] < A[s] (strict), else ns.  One running max/min per value of A.
    lidx = torch.full((ns,), -1, dtype=torch.int64, device=dev)
    ridx = torch.full((ns,), ns, dtype=torch.int64, device=dev)
    neg1 = torch.full((1,), -1, dtype=torch.int64, device=dev)
    end = torch.full((1,), ns, dtype=torch.int64, device=dev)
    for v in torch.unique(A).tolist():
        at_v = A == v
        cl = torch.where(A <= v, iota, -1).cummax(dim=0).values
        lidx = torch.where(at_v, torch.cat([neg1, cl[:-1]]), lidx)
        mr = torch.where(A < v, iota, ns).flip(0).cummin(dim=0).values.flip(0)
        ridx = torch.where(at_v, torch.cat([mr[1:], end]), ridx)

    lo = lidx + 1  # first leaf of node s's range
    hi = ridx      # last leaf (split index ns == leaf index L-1)

    # Parent = the lexicographically deeper of the two boundary splits
    # (ties pick the right boundary: larger index = lex greater).
    a1 = lo - 1
    Aa = A[a1.clamp(0, ns - 1)]
    Ab = A[hi.clamp(0, ns - 1)]
    has_l = a1 >= 0
    has_r = hi < ns
    is_root = ~has_l & ~has_r
    parent = torch.where(has_l & (~has_r | (Aa > Ab)), a1, hi)
    side_right = parent == a1  # node is its parent's right child

    # Leaves: boundaries are splits i-1 and i; same deeper-boundary rule.
    li = torch.arange(length, dtype=torch.int64, device=dev)
    Ap = torch.cat([neg1, A])  # A[i-1]
    An = torch.cat([A, neg1])  # A[i]
    lparent = torch.where((li >= 1) & (~(li < ns) | (Ap > An)), li - 1, li)
    lside_right = lparent == li - 1

    # Scatter children into (ns + 1)-row arrays; row ns absorbs the drops.
    left = torch.full((ns + 1,), EMPTY, dtype=torch.int64, device=dev)
    right = torch.full((ns + 1,), EMPTY, dtype=torch.int64, device=dev)
    tgt = torch.where(is_root, ns, parent)
    left[torch.where(side_right, ns, tgt)] = iota
    right[torch.where(side_right, tgt, ns)] = iota
    lcode = -li - 2
    left[torch.where(lside_right, ns, lparent)] = lcode
    right[torch.where(lside_right, lparent, ns)] = lcode
    left, right = left[:ns], right[:ns]

    # Renumber so the root occupies row 0 (the Scene/collapse contract).
    root_s = int(torch.argmax(is_root.to(torch.int8)))

    def remap(c):
        swapped = torch.where(c == root_s, 0, torch.where(c == 0, root_s, c))
        return torch.where(c >= 0, swapped, c)

    def swap0(arr):
        arr = arr.clone()
        arr[[0, root_s]] = arr[[root_s, 0]]
        return arr.to(torch.int32)

    return swap0(remap(left)), swap0(remap(right)), swap0(lo), swap0(hi)


def refit_ranges_flat(lo, hi, leaf_min, leaf_max):
    """AABB refit as range-min/max queries over each node's contiguous
    leaf range [lo, hi]: a sparse table of shifted mins/maxes (edge-
    replicated), answered with two row gathers per node."""
    global REFIT_LEVELS
    n_leaf = leaf_min.shape[0]
    levels = max(1, math.ceil(math.log2(max(n_leaf, 2)))) + 1
    REFIT_LEVELS = levels
    mins, maxs = [leaf_min], [leaf_max]
    cur_min, cur_max = leaf_min, leaf_max
    for lvl in range(1, levels):
        half = 1 << (lvl - 1)
        if half < n_leaf:
            cur_min = torch.minimum(cur_min, torch.cat(
                [cur_min[half:], cur_min[-1:].expand(half, 3)]))
            cur_max = torch.maximum(cur_max, torch.cat(
                [cur_max[half:], cur_max[-1:].expand(half, 3)]))
        else:
            cur_min = torch.minimum(cur_min, cur_min[-1:].expand_as(cur_min))
            cur_max = torch.maximum(cur_max, cur_max[-1:].expand_as(cur_max))
        mins.append(cur_min)
        maxs.append(cur_max)
    tab = torch.cat([torch.cat([m, M], dim=1) for m, M in zip(mins, maxs)])

    lo = lo.to(torch.int64)
    hi = hi.to(torch.int64)
    length = hi - lo + 1
    k = (31 - clz32(length.clamp_min(1))).clamp_max(levels - 1)  # floor log2
    b = (hi - (torch.ones_like(k) << k) + 1).clamp(0, n_leaf - 1)
    base = k * n_leaf
    ga = tab[base + lo]
    gb = tab[base + b]
    return (torch.minimum(ga[:, :3], gb[:, :3]),
            torch.maximum(ga[:, 3:], gb[:, 3:]))


def node_parents(left, right):
    """Parent index of each *internal* node (-1 for the root)."""
    n_int = left.shape[0]
    i = torch.arange(n_int, dtype=torch.int32, device=left.device)
    parent = torch.full((n_int + 1,), -1, dtype=torch.int32,
                        device=left.device)  # row n_int absorbs the drops
    for child in (left, right):
        c = child.long()
        parent[torch.where(c >= 0, c, n_int)] = i
    return parent[:n_int]


def node_depths(parent):
    """Depth of each internal node by pointer doubling (log passes)."""
    n_int = parent.shape[0]
    up = parent.long()
    depth = (up >= 0).to(torch.int32)
    for _ in range(max(1, math.ceil(math.log2(max(n_int, 2)))) + 1):
        upc = up.clamp(0, n_int - 1)
        depth = depth + torch.where(up >= 0, depth[upc], 0)
        up = torch.where(up >= 0, up[upc], -1)
    return depth


def refit_binary(left, right, leaf_min, leaf_max):
    """Bottom-up AABB refit of the binary tree as a fixpoint sweep, for
    trees without stored leaf ranges: each pass finalises every node whose
    children are both final, so the pass count is the tree's height.  The
    loop reads the root's flag on the host once a pass; the per-frame path
    (refit) uses refit_ranges_flat, which reads nothing back."""
    n_int = left.shape[0]
    n_leaf = leaf_min.shape[0]
    dev = leaf_min.device
    left, right = left.long(), right.long()

    def fetch(child, node_min, node_max, valid):
        leaf = is_leaf_code(child)
        li = leaf_id_of(child).clamp(0, n_leaf - 1)
        ni = child.clamp(0, n_int - 1)
        cmin = torch.where(leaf[:, None], leaf_min[li], node_min[ni])
        cmax = torch.where(leaf[:, None], leaf_max[li], node_max[ni])
        return cmin, cmax, leaf | valid[ni]

    node_min = torch.full((n_int, 3), float("inf"), device=dev)
    node_max = torch.full((n_int, 3), -float("inf"), device=dev)
    valid = torch.zeros((n_int,), dtype=torch.bool, device=dev)
    while not bool(valid[0]):  # root valid <=> whole tree valid
        lmin, lmax, lval = fetch(left, node_min, node_max, valid)
        rmin, rmax, rval = fetch(right, node_min, node_max, valid)
        ok = (lval & rval)[:, None]
        node_min = torch.where(ok, torch.minimum(lmin, rmin), node_min)
        node_max = torch.where(ok, torch.maximum(lmax, rmax), node_max)
        valid = valid | ok[:, 0]
    return node_min, node_max

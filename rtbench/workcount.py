"""The roofline's work count: the benchmark's own tree and traversal.

A configuration states its tree: an LBVH of a given width and leaf size.
`build_lbvh` builds that tree from the soup alone (30-bit Morton codes of
the triangle centroids in the centroids' bounds, a stable sort, leaves of
`leaf_size` consecutive triangles, the binary hierarchy split at the
highest differing bit of the leaves' first codes, then collapsed to
`width` children by opening the child of largest surface area first).
`count` walks it for a sample of rays, closest hit first (children pushed
far to near, a popped entry skipped once it lies beyond the best hit), and
counts the child box tests (live children of each popped node) and the
triangle tests (the real triangles of each popped leaf) that each ray
needs.  Nothing here reads the program's tables or counts, so a change to
the program's traversal or node format does not move the count.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from rtbench import reference

# f32 operations a test, counted from the tests as rtk states them: a child
# box test is 6 sub, 6 mul, 6 max/min and 1 compare; a triangle test is 9
# sub to translate 3 vertices, 15 mul/add to shear them, 9 mul/sub for the
# edge functions, 3 compares for the exact-zero test, 4 min/max, 2 add and
# 1 divide for 1/det, 6 mul/add for t and 4 compares.  Per-ray set-up and
# the ordering of the children are not counted.
OPS_PER_BOX = 19
OPS_PER_TRI = 53
# Bytes a ray moves at the least: its origin, direction, min_t and max_t
# in (32) and its record t, u, v and triangle index out (16); the soup is
# read once (36 a triangle).
BYTES_PER_RAY = 32 + 16
BYTES_PER_TRI = 36


@dataclasses.dataclass
class Tree:
    child: torch.Tensor  # (Nw, W) int64: >= 0 node, -(l + 1) leaf, EMPTY
    cmin: torch.Tensor  # (Nw, W, 3) f32 child boxes
    cmax: torch.Tensor
    leaf_tris: torch.Tensor  # (L, leaf_size, 3, 3) f32, padded
    leaf_count: torch.Tensor  # (L,) int64 real triangles of each leaf
    depth: int
    width: int


EMPTY = -(1 << 40)


def _morton30(c: np.ndarray) -> np.ndarray:
    lo, hi = c.min(axis=0), c.max(axis=0)
    ext = np.where(hi > lo, hi - lo, 1.0)
    q = np.clip(((c - lo) / ext * 1024.0).astype(np.int64), 0, 1023)
    code = np.zeros(len(c), np.int64)
    for b in range(10):
        for a in range(3):
            code |= ((q[:, a] >> b) & 1) << (3 * b + (2 - a))
    return code


def _area(lo, hi):
    e = hi - lo
    return e[0] * e[1] + e[1] * e[2] + e[2] * e[0]


def build_lbvh(soup: np.ndarray, leaf_size: int, width: int) -> Tree:
    """The configuration's tree over `soup` (T, 3, 3), on the host."""
    soup = np.asarray(soup, np.float32)
    codes = _morton30(soup.astype(np.float64).mean(axis=1))
    order = np.argsort(codes, kind="stable")
    n_leaves = -(-len(soup) // leaf_size)
    pad = n_leaves * leaf_size - len(soup)
    tris = soup[order]
    leaf_tris = np.concatenate([tris, np.zeros((pad, 3, 3), np.float32)])
    leaf_tris = leaf_tris.reshape(n_leaves, leaf_size, 3, 3)
    leaf_count = np.full(n_leaves, leaf_size, np.int64)
    leaf_count[-1] = leaf_size - pad
    pts = leaf_tris.reshape(n_leaves, leaf_size * 3, 3)
    real = (np.arange(leaf_size * 3)[None] < 3 * leaf_count[:, None])[..., None]
    leaf_lo = np.where(real, pts, np.inf).min(axis=1).astype(np.float32)
    leaf_hi = np.where(real, pts, -np.inf).max(axis=1).astype(np.float32)
    lcode = codes[order][::leaf_size]

    # Binary hierarchy over leaf ranges: node -> (left, right), each a node
    # id or -(l + 1) for leaf l.
    left, right, rng = [], [], []

    def node(lo, hi):
        if lo == hi:
            return -(lo + 1)
        left.append(None), right.append(None), rng.append((lo, hi))
        return len(rng) - 1

    root = node(0, n_leaves - 1)
    todo = [root] if root >= 0 else []
    while todo:
        i = todo.pop()
        lo, hi = rng[i]
        diff = int(lcode[lo] ^ lcode[hi])
        if diff == 0:
            split = (lo + hi + 1) // 2
        else:
            b = diff.bit_length() - 1
            key = ((int(lcode[lo]) >> b) + 1) << b
            split = lo + int(np.searchsorted(lcode[lo:hi + 1], key))
        left[i], right[i] = node(lo, split - 1), node(split, hi)
        todo += [c for c in (left[i], right[i]) if c >= 0]
    nb = len(rng)
    blo = np.zeros((nb, 3), np.float32)
    bhi = np.zeros((nb, 3), np.float32)

    def box(c):
        return (leaf_lo[-c - 1], leaf_hi[-c - 1]) if c < 0 else (blo[c],
                                                                 bhi[c])

    for i in range(nb - 1, -1, -1):  # children have larger ids
        (a0, a1), (b0, b1) = box(left[i]), box(right[i])
        blo[i], bhi[i] = np.minimum(a0, b0), np.maximum(a1, b1)

    # Collapse to `width` children a node, breadth first: a wide node's
    # id is its place in `queue`.
    queue, level, rows = [root], [1], []
    for b in queue:
        kids = [b] if b < 0 else [left[b], right[b]]
        while len(kids) < width:
            inner = [k for k in kids if k >= 0]
            if not inner:
                break
            k = max(inner, key=lambda k: _area(*box(k)))
            kids.remove(k)
            kids += [left[k], right[k]]
        row = []
        for k in kids:
            if k >= 0:
                row.append(len(queue))
                level.append(level[len(rows)] + 1)
                queue.append(k)
            else:
                row.append(k)
        rows.append((row, kids))
    nw = len(rows)
    child = np.full((nw, width), EMPTY, np.int64)
    cmin = np.zeros((nw, width, 3), np.float32)
    cmax = np.zeros((nw, width, 3), np.float32)
    for i, (row, kids) in enumerate(rows):
        child[i, :len(row)] = row
        for j, k in enumerate(kids):
            cmin[i, j], cmax[i, j] = box(k)
    return Tree(child=torch.from_numpy(child), cmin=torch.from_numpy(cmin),
                cmax=torch.from_numpy(cmax),
                leaf_tris=torch.from_numpy(leaf_tris),
                leaf_count=torch.from_numpy(leaf_count), depth=max(level),
                width=width)


def count(tree: Tree, origin, direction, min_t, max_t):
    """Walk `tree` (its tensors on the rays' device) for each ray ->
    (box tests (N,) int64, triangle tests (N,) int64, closest t (N,) f32,
    max_t where nothing is hit).  All rays step together, one popped
    entry each a step, until every stack is empty."""
    dev = origin.device
    n, w = origin.shape[0], tree.width
    size = tree.depth * (w - 1) + 2
    stack = torch.zeros((n, size), dtype=torch.int64, device=dev)
    enter = torch.full((n, size), -float("inf"), device=dev)
    sp = torch.ones(n, dtype=torch.int64, device=dev)
    best = max_t.to(torch.float32).clone()
    boxes = torch.zeros(n, dtype=torch.int64, device=dev)
    tests = torch.zeros(n, dtype=torch.int64, device=dev)
    rcp = 1.0 / direction
    slots = torch.arange(w, device=dev)
    ls = tree.leaf_tris.shape[1]
    while True:
        live = (sp > 0).nonzero()[:, 0]
        if live.numel() == 0:
            break
        sp[live] -= 1
        top = sp[live]
        entry, te = stack[live, top], enter[live, top]
        keep = te < best[live]
        live, entry = live[keep], entry[keep]
        inner = entry >= 0
        r, nd = live[inner], entry[inner]
        if r.numel():
            kids = tree.child[nd]
            real = kids != EMPTY
            boxes[r] += real.sum(dim=1)
            o, q = origin[r][:, None], rcp[r][:, None]
            lo, hi = tree.cmin[nd], tree.cmax[nd]
            pos = q >= 0
            near = (torch.where(pos, lo, hi) - o) * q
            far = (torch.where(pos, hi, lo) - o) * q
            t0 = torch.fmax(near.amax(dim=2), min_t[r][:, None])
            t1 = torch.fmin(far.amin(dim=2), best[r][:, None])
            hit = real & (t0 <= t1)
            key = torch.where(hit, t0, torch.full_like(t0, -float("inf")))
            key, order = key.sort(dim=1, descending=True, stable=True)
            kids = kids.gather(1, order)
            k = hit.sum(dim=1)
            put = slots[None] < k[:, None]
            rows = r[:, None].expand(-1, w)[put]
            at = (sp[r][:, None] + slots[None])[put]
            stack[rows, at] = kids[put]
            enter[rows, at] = key[put]
            sp[r] += k
        r, leaf = live[~inner], -entry[~inner] - 1
        if r.numel():
            cnt = tree.leaf_count[leaf]
            tests[r] += cnt
            h, t, _, _ = reference.per_ray(
                tree.leaf_tris[leaf], origin[r], direction[r], min_t[r],
                best[r])
            h &= torch.arange(ls, device=dev)[None] < cnt[:, None]
            t = torch.where(h, t, torch.full_like(t, float("inf")))
            best[r] = torch.minimum(best[r], t.amin(dim=1))
    return boxes, tests, best

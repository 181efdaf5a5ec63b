"""Morton (Z-order) codes for LBVH construction and ray coherence sorting.

rtk_tpu computes these in uint32; PyTorch has little unsigned arithmetic,
so codes here are int32 tensors holding the same 30-bit values: every
intermediate below stays under 2^31, so no step can overflow or differ,
and a key pass or a sort moves four bytes a code as the reference's does.
Custom build keys that use all 32 bits (build_from_soup(codes=)) are
widened to int64 by their callers, never held here.
"""
from __future__ import annotations

import torch


def expand_bits10(v: torch.Tensor) -> torch.Tensor:
    """Spread the low 10 bits of each value to every 3rd bit (int32)."""
    v = v.to(torch.int32)
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    v = (v | (v << 2)) & 0x09249249
    return v


def morton3d(points: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
             bits: int = 10) -> torch.Tensor:
    """Morton codes of points (..., 3) quantised inside [lo, hi] bounds.

    Returns int32 codes with 3*bits significant bits, equal to
    rtk_tpu.ops.morton.morton3d's uint32 codes.
    """
    points = points.to(torch.float32)
    scale = float((1 << bits) - 1)
    extent = torch.clamp_min(hi - lo, 1e-30)
    q = (points - lo) / extent
    q = torch.clamp(q * scale, 0.0, scale)
    qi = q.to(torch.int32)  # truncation, as the f32 -> u32 convert
    shift = 10 - bits
    ex = expand_bits10(qi << shift if shift else qi)
    return (ex[..., 0] << 2) | (ex[..., 1] << 1) | ex[..., 2]


def scene_bounds(tri_pos: torch.Tensor):
    """(min, max) over all triangle vertices. tri_pos: (T, 3, 3)."""
    p = tri_pos.reshape(-1, 3)
    return p.amin(dim=0), p.amax(dim=0)


def sort_by_morton(codes: torch.Tensor):
    """Sort Morton codes, returning (sorted_codes, permutation (int32)).

    Ties are broken by index (a stable sort), so the order is total, as
    the Karras topology's duplicate-code handling needs (builder/lbvh.py).
    """
    sorted_codes, perm = torch.sort(codes, stable=True)
    return sorted_codes, perm.to(torch.int32)


def ray_coherence_key(origin: torch.Tensor,
                      direction: torch.Tensor) -> torch.Tensor:
    """Spatial-coherence sort key for a ray batch (int32, 30 bits).

    Morton code of a probe point pushed along each ray: for shared-origin
    batches (camera primaries) the probes spread over a sphere patch, so
    the key orders rays by direction; for scattered origins (bounce
    batches) origin locality dominates and direction refines it.  Rays
    adjacent in this order visit nearly the same BVH nodes, so a warp of
    them diverges less and shares more of its node fetches.

    The key is the front end's (ops/packet_trace.front_steps, by the
    origins' device): on CUDA tensors the port's own kernels
    (coherence_key_kernel, csrc/coherence_key.cu), which raise if they
    cannot run; on the CPU the plain version, ray_coherence_key_reference.
    The two give the same bits.
    """
    # Imported here: ops/packet_trace.py imports this module.
    from rtk_tpu_torch.ops.packet_trace import front_steps
    return front_steps(origin.device).key(origin, direction)


def ray_coherence_key_reference(origin: torch.Tensor,
                                direction: torch.Tensor) -> torch.Tensor:
    """ray_coherence_key's plain version: eager tensor operations on any
    device, in rtk_tpu.ops.morton.ray_coherence_key's order (on the CPU
    its keys equal the reference's)."""
    o = origin.to(torch.float32)
    d = direction.to(torch.float32)
    dn = d / torch.clamp_min(torch.linalg.vector_norm(d, dim=1, keepdim=True),
                             1e-30)
    o_lo = o.amin(dim=0)
    o_hi = o.amax(dim=0)
    diag = torch.linalg.vector_norm(o_hi - o_lo)
    scale = torch.maximum(0.5 * diag, 1e-2 * (1.0 + o_hi.abs().amax()))
    probe = o + dn * scale
    return morton3d(probe, probe.amin(dim=0), probe.amax(dim=0), bits=10)

"""Debug validation paths: NaN, shape and index checks for ray batches
and scenes (rtk_tpu.testing.checks).

What is worth checking is malformed input: NaN/Inf rays, NaN t-windows,
index tables pointing outside their arrays.  Each check reads its tensors
back to the host once (tensors on any device) and is meant for debug runs
and tests, not the hot path.  `checkify_trace` wraps a trace function and
reports NaN/Inf in what it returns.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


class ValidationError(ValueError):
    pass


def _np(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def validate_rays(rays, name: str = "rays") -> None:
    """Raise ValidationError on NaN/Inf origins or directions, NaN
    t-window bounds, or all-zero directions (which trace as misses but
    usually indicate an upstream bug)."""
    o, d, mn, mx = (_np(getattr(rays, f))
                    for f in ("origin", "direction", "min_t", "max_t"))
    if not np.isfinite(o).all():
        raise ValidationError(f"{name}.origin contains NaN/Inf")
    if not np.isfinite(d).all():
        raise ValidationError(f"{name}.direction contains NaN/Inf")
    if np.isnan(mn).any() or np.isnan(mx).any():
        raise ValidationError(f"{name} t-window contains NaN")
    if (np.abs(d).sum(axis=1) == 0).any():
        raise ValidationError(f"{name}.direction has all-zero rows")


def validate_scene(scene) -> None:
    """Structural invariants of a built Scene: finite bounds, child ids in
    range, leaf codes within the leaf table, triangle padding marked."""
    nb = _np(scene.node_child)
    nn = nb.shape[0]
    internal = nb >= 0
    leaf = nb <= -2
    if internal.any() and int(nb[internal].max()) >= nn:
        raise ValidationError("node_child points past the node table")
    if leaf.any() and int((-nb[leaf] - 2).max()) >= scene.num_leaves:
        raise ValidationError("leaf code points past the leaf table")
    if not np.isfinite(_np(scene.bounds_min)).all():
        raise ValidationError("scene bounds_min not finite")
    if not np.isfinite(_np(scene.bounds_max)).all():
        raise ValidationError("scene bounds_max not finite")
    if not np.isfinite(_np(scene.tri_v[: scene.num_tris])).all():
        raise ValidationError("triangle vertices contain NaN/Inf")
    if (_np(scene.tri_vidx[: scene.num_tris]) < 0).any():
        raise ValidationError("real triangles carry negative vertex ids")


class CheckError:
    """What checkify_trace's wrapper returns beside the output: the first
    failed check, or none.  get() is its message or None; throw() raises
    ValidationError if a check failed."""

    def __init__(self, message: str | None = None):
        self.message = message

    def get(self) -> str | None:
        return self.message

    def throw(self) -> None:
        if self.message is not None:
            raise ValidationError(self.message)


def _float_tensors(out, path="out"):
    """(path, tensor) of every floating tensor in a nest of tuples, lists,
    dicts and dataclasses."""
    if isinstance(out, torch.Tensor):
        if out.is_floating_point():
            yield path, out
    elif isinstance(out, (tuple, list)):
        for i, x in enumerate(out):
            yield from _float_tensors(x, f"{path}[{i}]")
    elif isinstance(out, dict):
        for k, x in out.items():
            yield from _float_tensors(x, f"{path}[{k!r}]")
    elif dataclasses.is_dataclass(out) and not isinstance(out, type):
        for f in dataclasses.fields(out):
            yield from _float_tensors(getattr(out, f.name),
                                      f"{path}.{f.name}")


def checkify_trace(fn):
    """Wrap a trace function with a NaN/Inf check of its output.

    Returns wrapped(*args, **kwargs) -> (err, out); call err.throw() to
    surface the first failure as a ValidationError.  rtk_tpu wraps with
    jax.experimental.checkify, which also instruments the operations
    inside a compiled function (NaN made and consumed inside, divisions by
    zero, out-of-bounds indices).  Eager PyTorch needs no instrumenting
    for the last: an out-of-range index raises on the CPU and trips a
    device-side assert on the card.  NaN or division by zero that never
    reaches the output is not seen here.  A miss's t at the +inf sentinel
    (3.4e38) is finite; an infinite max_t carried into a miss's t is
    reported.
    """
    def wrapped(*args, **kwargs):
        out = fn(*args, **kwargs)
        for path, x in _float_tensors(out):
            if not bool(torch.isfinite(x).all()):
                kind = "NaN" if bool(torch.isnan(x).any()) else "Inf"
                return CheckError(f"{kind} in {path} of "
                                  f"{getattr(fn, '__name__', 'fn')}"), out
        return CheckError(), out

    return wrapped

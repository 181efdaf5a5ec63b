"""The parameter carry: rtk_tpu scene tables, grids, stackless entity
tables, materials and hit records (handed over as NumPy arrays) -> this
package's Scene / PackedScene / BinaryRefitAux / GridScene /
StacklessScene / Materials / Hits on a given device.

A test takes rtk_tpu's arrays with np.asarray, passes the dict here, and
feeds both packages the very same tables.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from rtk_tpu_torch.models.path import Materials
from rtk_tpu_torch.scene import Scene
from rtk_tpu_torch.testing.grid import GridScene
from rtk_tpu_torch.trace.stackless import StacklessScene
from rtk_tpu_torch.trace.packed import (BinaryRefitAux, PackedScene,
                                        tree_depth)
from rtk_tpu_torch.types import Hits

SCENE_ARRAYS = tuple(f.name for f in dataclasses.fields(Scene)
                     if f.type == "torch.Tensor")
PACKED_ARRAYS = tuple(f.name for f in dataclasses.fields(PackedScene)
                      if f.type == "torch.Tensor")

REFIT_AUX_ARRAYS = tuple(f.name for f in dataclasses.fields(BinaryRefitAux))
# A rounds-engine GridScene's own arrays (its two tables are PackedScenes).
GRID_ARRAYS = ("rank", "cells_to_flat", "grid_lo", "cell_size")
STACKLESS_ARRAYS = tuple(f.name for f in dataclasses.fields(StacklessScene)
                         if f.type == "torch.Tensor")

# Integer tables keep int32 (rtk_tpu's dtype); floats are float32.
_DTYPES = {np.dtype(np.int32): torch.int32, np.dtype(np.int64): torch.int32,
           np.dtype(np.float32): torch.float32,
           np.dtype(np.float64): torch.float32}


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    a = np.array(a)  # a writable copy: rtk_tpu hands out read-only views
    return torch.as_tensor(a, device=device).to(_DTYPES[a.dtype])


def scene_from_arrays(arrays: dict, *, num_tris: int, leaf_size: int,
                      branching: int, num_leaves: int, has_wide: bool = True,
                      device) -> Scene:
    """Scene from a dict holding every name in SCENE_ARRAYS."""
    return Scene(**{k: _tensor(arrays[k], device) for k in SCENE_ARRAYS},
                 num_tris=num_tris, leaf_size=leaf_size,
                 branching=branching, num_leaves=num_leaves,
                 has_wide=has_wide)


def packed_from_arrays(arrays: dict, *, num_tris: int, leaf_size: int,
                       branching: int = 8, roots=None,
                       device) -> PackedScene:
    """PackedScene from a dict holding every name in PACKED_ARRAYS; the
    tree depth is read from the `meta` table: the deepest tree over
    `roots` (the table's entry rows; default: every row that no other row
    names as a child)."""
    return PackedScene(
        **{k: _tensor(arrays[k], device) for k in PACKED_ARRAYS},
        num_tris=num_tris, leaf_size=leaf_size, branching=branching,
        depth=tree_depth(np.asarray(arrays["meta"]), roots, branching))


def refit_aux_from_arrays(arrays: dict, *, device) -> BinaryRefitAux:
    """BinaryRefitAux from a dict holding every name in REFIT_AUX_ARRAYS,
    so a table that rtk_tpu packed can be refit here."""
    return BinaryRefitAux(**{k: _tensor(arrays[k], device)
                             for k in REFIT_AUX_ARRAYS})


def grid_from_arrays(arrays: dict, *, cells: PackedScene, flat: PackedScene,
                     dims, n_occ: int, device) -> GridScene:
    """A rounds-engine GridScene from a dict holding every name in
    GRID_ARRAYS and its two tables carried already (packed_from_arrays of
    rtk_tpu's grid.cells and grid.flat), so the rounds can be held
    against rtk_tpu's on the very same grid."""
    return GridScene(cells=cells, flat=flat,
                     **{k: _tensor(arrays[k], device) for k in GRID_ARRAYS},
                     dims=tuple(int(x) for x in dims), n_occ=int(n_occ))


def stackless_from_arrays(arrays: dict, *, num_tris: int,
                          device) -> StacklessScene:
    """StacklessScene from a dict holding every name in
    STACKLESS_ARRAYS (rtk_tpu's entity table and triangle arrays)."""
    return StacklessScene(
        **{k: _tensor(arrays[k], device) for k in STACKLESS_ARRAYS},
        num_tris=num_tris)


def materials_from_arrays(albedo, emission=None, *, device) -> Materials:
    """Materials from rtk_tpu's (M, 3) albedo and emission arrays."""
    return Materials.make(np.array(albedo, np.float32),
                          None if emission is None
                          else np.array(emission, np.float32), device=device)


def hits_from_arrays(arrays: dict, *, device) -> Hits:
    """Hits from a dict holding every field of an rtk_tpu Hits (a
    PacketHits' `.full()`) as NumPy arrays, so one trace's records can be
    shaded by both packages."""
    return Hits(**{f.name: torch.as_tensor(np.array(arrays[f.name]),
                                           device=device)
                   for f in dataclasses.fields(Hits)})

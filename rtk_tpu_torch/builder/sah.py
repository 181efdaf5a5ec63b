"""SAH build option: host-native binned-SAH topology, device-packed.

The default builder is the on-device LBVH (scene.py).  For static scenes
traced many times, a higher-quality tree pays for itself: this builds the
binary topology with the native C++ binned-SAH builder (rtk's build
strategy, rtk.c:867-1019) and feeds it through the same greedy wide
collapse as the LBVH path, so the kernel sees the identical table format.
"""
from __future__ import annotations

import numpy as np

from rtk_tpu_torch.config import BuildConfig
from rtk_tpu_torch.mesh import TriangleSoup, build_soup
from rtk_tpu_torch.trace.packed import PackedScene, pack_binary_tree
from rtk_tpu_torch.utils.native_sah import NativeOracle


def build_sah_packed(meshes, config: BuildConfig = BuildConfig(),
                     tri_mask=None, step_quant: bool = False,
                     device="cpu") -> PackedScene:
    """Build a PackedScene with host-native binned-SAH topology on `device`.

    Accepts the same mesh inputs as build_scene (MeshDesc, (positions,
    indices), TriangleSoup, or a sequence).  Returns the kernel tables
    directly (no intermediate Scene).

    step_quant: weight the SAH by leaf steps (ceil(count/leaf_size)), the
    unit the kernel tests leaves in; topology only.
    """
    soup = meshes if isinstance(meshes, TriangleSoup) else build_soup(meshes)
    tri_pos = np.asarray(soup.tri_pos, np.float32)
    orc = NativeOracle(tri_pos.reshape(-1, 9), leaf_max=config.leaf_size,
                       step_quant=step_quant)
    return pack_binary_tree(
        tri_pos, *orc.export_tree(), leaf_size=config.leaf_size,
        tri_vidx=soup.tri_vidx, tri_mesh=soup.tri_mesh,
        tri_prim=soup.tri_prim, tri_mask=tri_mask, device=device)

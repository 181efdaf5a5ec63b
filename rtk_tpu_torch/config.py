"""Build/trace configuration (the same fields as rtk_tpu.config).

The reference (rtk.c:3-7, 586-592) exposes these as compile-time #defines:
RTK_BVH_MAX_DEPTH=64, leaf min/max items 4/64, RTK_BUILD_SPLITS=32,
RTK_MAX_CONCURRENT_TASKS=128.  Here they are frozen dataclasses.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class BuildConfig:
    """Configuration for BVH construction.

    Attributes:
      leaf_size: triangles per leaf (rtk: RTK_BVH_LEAF_MIN_ITEMS=4).
      branching: wide-node arity W of Scene.node_child; 2, 4 or 8 (the
        packed kernel tables have a width of their own, 8 from a Scene
        and 8 or 16 from pack_binary_tree, see trace/packed.py).
      morton_bits: bits per axis of the Morton code (<=10 for 30-bit keys).
      wide_nodes: also build the wide (branching-ary) SoA node arrays.
        The packet kernel derives its own tables from the binary topology.
    """

    leaf_size: int = 4
    branching: int = 8
    morton_bits: int = 10
    wide_nodes: bool = True

    def __post_init__(self):
        if self.branching not in (2, 4, 8):
            raise ValueError("branching must be 2, 4, or 8")
        if not (1 <= self.leaf_size <= 64):
            # rtk bounds leaf items to 64 (rtk.c:588 RTK_BVH_LEAF_MAX_ITEMS)
            raise ValueError("leaf_size must be in [1, 64]")
        if not (1 <= self.morton_bits <= 10):
            raise ValueError("morton_bits must be in [1, 10]")

    @property
    def log2_branching(self) -> int:
        return {2: 1, 4: 2, 8: 3}[self.branching]


@dataclasses.dataclass(frozen=True)
class TraceConfig:
    """Configuration for traversal.

    Attributes:
      max_stack: accepted for API parity.  The packet kernel sizes its
        per-ray stack from the packed tree depth instead (and raises when
        that exceeds its compiled maximum).
      watertight: resolve exact-zero shear-space edge functions in f64,
        as rtk does (rtk.c:294-336).
      max_steps, block_rays: accepted for API parity; unused by the
        packet kernel.
      dual_queues: the TPU kernel's split internal/leaf stepping.  A
        scheduling choice on the TPU with identical results; accepted
        and ignored here.
      defer_uv: the kernel writes t and slot only; PacketHits recomputes
        u/v lazily on access with the same watertight test.
      pkt / packets_per_block: the TPU kernel's block geometry.  Accepted
        and ignored: the CUDA kernel runs one thread per ray.
    """

    max_stack: int = 48
    watertight: bool = True
    max_steps: int = 0
    block_rays: int = 0
    dual_queues: bool | None = None
    defer_uv: bool = False
    pkt: int | None = None
    packets_per_block: int | None = None

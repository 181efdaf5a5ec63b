"""rtk_tpu_torch: the rtk_tpu ray-query engine in PyTorch, with its traversal
kernel written in CUDA for Hopper (H100).

The same API and hit-record contract as rtk_tpu: build a scene (LBVH on
the device, or a host SAH topology), trace closest-hit and any-hit ray
batches, and trace instanced (TLAS/BLAS) scenes.  Imports torch and
numpy; never jax.
"""

from rtk_tpu_torch.api import (
    BuildConfig,
    Hits,
    MeshDesc,
    PacketHits,
    Rays,
    Scene,
    TraceConfig,
    Tracer,
    TriangleSoup,
    build_from_soup,
    build_instanced,
    build_sah_packed,
    build_scene,
    pack_instanced,
    trace_closest_instanced,
    trace_closest_instanced_packets,
)

__version__ = "0.1.0"

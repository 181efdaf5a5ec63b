"""rtk_tpu_torch: the rtk_tpu ray-query engine in PyTorch, with its traversal
kernel written in CUDA for Hopper (H100).

The same API and hit-record contract as rtk_tpu: build a scene (LBVH on
the device, or a host SAH topology), refit it to moved vertices, trace
closest-hit and any-hit ray batches (with filter callables), trace
instanced (TLAS/BLAS) scenes, render with them (models.path: path
tracing, direct lighting, ambient occlusion), save and load scenes in
rtk_tpu's blob format, and drive it through rtk's task lifecycle and C
entry points (tasks, compat).  Imports torch and numpy; never jax.
"""

from rtk_tpu_torch.api import (
    BuildConfig,
    HitCandidate,
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
    jit_filter,
    load_any,
    load_instanced_scene,
    load_packed_scene,
    load_scene,
    pack_instanced,
    refit,
    save_instanced_scene,
    save_packed_scene,
    save_scene,
    trace_any,
    trace_closest,
    trace_closest_instanced,
    trace_closest_instanced_packets,
)

__version__ = "0.1.0"

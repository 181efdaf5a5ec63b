"""The macro-grid engine's import path of rtk_tpu (rtk_tpu.trace.grid):
the engine lives in rtk_tpu_torch.testing.grid."""
from rtk_tpu_torch.testing.grid import (GridScene, build_grid,  # noqa: F401
                                        build_grid_from_scene,
                                        calibrate_caps, choose_dims,
                                        trace_packets_grid,
                                        trace_packets_march)

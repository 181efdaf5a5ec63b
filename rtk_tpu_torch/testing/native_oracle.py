"""Test-suite alias for the native SAH binding (utils/native_sah.py), as
rtk_tpu.testing.native_oracle re-exports rtk_tpu's: the binding is the
test oracle and the host-side SAH builder (builder/sah.py) at once."""
from rtk_tpu_torch.utils.native_sah import NativeOracle

__all__ = ["NativeOracle"]

"""rtk_tpu_torch never imports jax or flax: the card machine has neither."""
import os
import subprocess
import sys
import textwrap

import pytest
import torch

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Importing a module whose entry in sys.modules is None raises ImportError,
# so any jax/flax import anywhere under the package fails the subprocess.
# (A subprocess: this test process imported jax through conftest.)
_PROBE = textwrap.dedent("""
    import sys
    sys.modules["jax"] = None
    sys.modules["flax"] = None
    import rtk_tpu_torch
    {extra}
    bad = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "flax", "jaxlib", "rtk_tpu")
                 and sys.modules[m] is not None)
    assert not bad, bad
    print("ok")
""")

MODULES = [
    "rtk_tpu_torch.ops.packet_trace", "rtk_tpu_torch.testing.scenes",
    "rtk_tpu_torch.testing.carry", "rtk_tpu_torch.utils.native_sah",
    "rtk_tpu_torch.ops.filter_capture", "rtk_tpu_torch.utils.stats",
    "rtk_tpu_torch.utils.serialize", "rtk_tpu_torch.tasks",
    "rtk_tpu_torch.compat", "rtk_tpu_torch.testing.grid",
    "rtk_tpu_torch.trace.grid", "rtk_tpu_torch.models.path",
    # The modules of the dynamic-scene path.
    "rtk_tpu_torch.scene", "rtk_tpu_torch.trace.packed",
    "rtk_tpu_torch.builder.lbvh", "rtk_tpu_torch.builder.sah",
    "rtk_tpu_torch.tracer", "rtk_tpu_torch.ops.morton",
    # The render path's small modules.
    "rtk_tpu_torch.testing.checks", "rtk_tpu_torch.oracle",
    "rtk_tpu_torch.utils.native_host", "rtk_tpu_torch.mesh",
    # Sharding and serving artifacts.
    "rtk_tpu_torch.parallel.shard", "rtk_tpu_torch.utils.aot",
    # The batch-sizing cost model.
    "rtk_tpu_torch.utils.costmodel",
    # The plain path tracer the render loop is held to.
    "rtk_tpu_torch.testing.path_reference",
]

EXAMPLES = ["torch_render_cornell", "torch_animate_deform",
            "torch_port_from_rtk", "torch_shard_multichip", "torch_serve_aot"]

# The port's profiling tools (their main() not run).
TOOLS = ["torch_profile_trace", "torch_profile_refit"]


@pytest.mark.parametrize("module", [None] + MODULES)
def test_port_imports_without_jax(module):
    extra = f"import {module}" if module else ""
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE.format(extra=extra)], cwd=REPO,
        capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": REPO})
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", (
        proc.stdout + proc.stderr)


@pytest.mark.parametrize("example", EXAMPLES)
def test_examples_import_without_jax(example):
    """The port-side examples load (their main() not run) with jax and
    flax unimportable, and pull in nothing of rtk_tpu."""
    extra = ("import importlib.util as u; "
             f"s = u.spec_from_file_location('ex', 'examples/{example}.py'); "
             "m = u.module_from_spec(s); s.loader.exec_module(m)")
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE.format(extra=extra)], cwd=REPO,
        capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": REPO})
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", (
        proc.stdout + proc.stderr)


@pytest.mark.parametrize("tool", TOOLS)
def test_tools_import_without_jax(tool):
    """The port's profiling tools load (their main() not run) with jax and
    flax unimportable, and pull in nothing of rtk_tpu."""
    extra = ("import importlib.util as u; "
             f"s = u.spec_from_file_location('t', 'tools/{tool}.py'); "
             "m = u.module_from_spec(s); s.loader.exec_module(m)")
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE.format(extra=extra)], cwd=REPO,
        capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": REPO})
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", (
        proc.stdout + proc.stderr)

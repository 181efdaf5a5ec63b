"""Files of the benchmark imported by their path: scene generators,
traffic kinds, query kinds and per-layer metric readers, each found by the
name that BENCHMARK.json or a data file gives it."""
from __future__ import annotations

import importlib.util
from pathlib import Path

_LOADED: dict = {}


def load_module(path: Path):
    """Import a file of the benchmark by its path (once a process)."""
    path = Path(path).resolve()
    if path not in _LOADED:
        if not path.is_file():
            raise FileNotFoundError(f"no benchmark file {path}")
        name = "rtbench_file_" + "_".join(path.with_suffix("").parts[-2:])
        spec = importlib.util.spec_from_file_location(
            name.replace(".", "_").replace("-", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _LOADED[path] = mod
    return _LOADED[path]

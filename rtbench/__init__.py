"""rtbench: the benchmark of rtk_tpu_torch (see BENCHMARK.json and run.py)."""

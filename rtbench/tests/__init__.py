"""CPU tests of the benchmark (python -m pytest rtbench/tests -q)."""

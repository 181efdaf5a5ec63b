"""Rendering workloads on top of the ray-query engine."""

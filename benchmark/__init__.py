"""Benchmark of ls1_mardyn_tpu_torch on one NVIDIA GPU (see run.py)."""

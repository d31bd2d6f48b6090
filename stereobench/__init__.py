"""The benchmark of custereomatching_tpu_torch on one NVIDIA H100 (BENCHMARK.json at the root names its cells)."""

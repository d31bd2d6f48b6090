"""Version of the custereomatching_tpu_torch package (the PyTorch/CUDA port
of custereomatching_tpu; it tracks the JAX package's version)."""

__version__ = "0.2.0"

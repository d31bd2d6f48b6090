"""Runnable examples of the port (``python -m
custereomatching_tpu_torch.examples.<name>``)."""

"""Microbenchmarks of the port (``python -m sensorium_tpu_torch.tools.<name>``)."""

"""Measurement entry points of the port (run as ``python3 -m
sfm_tpu_torch.tools.<name>``)."""

"""Run modes of the port (``python -m vdpp_tpu_torch.modes.<name>``)."""

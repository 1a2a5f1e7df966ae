"""Command-line applications of the port (``python -m vdpp_tpu_torch.apps.<name>``)."""

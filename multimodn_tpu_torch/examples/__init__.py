"""Runnable tours of the port's surface (``python -m
multimodn_tpu_torch.examples.<name>``)."""

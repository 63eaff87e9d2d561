"""Diagnostic entry points of the port (``python -m annonet_tpu_torch.tools.<name>``)."""

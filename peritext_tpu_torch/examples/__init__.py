"""Runnable demos of the port (``python -m peritext_tpu_torch.examples.<name>``)."""

"""Host runtime of the PyTorch port (causal ordering)."""

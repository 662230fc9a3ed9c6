"""Workload generation for the PyTorch port."""

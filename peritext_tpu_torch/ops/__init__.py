"""Device data plane of the PyTorch port: state, encode, merge, kernels."""

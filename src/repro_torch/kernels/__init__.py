"""repro_torch.kernels — see the package docstring of repro_torch."""

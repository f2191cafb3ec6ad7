"""repro_torch.fl — see the package docstring of repro_torch."""

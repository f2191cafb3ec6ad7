"""repro_torch.launch — see the package docstring of repro_torch."""

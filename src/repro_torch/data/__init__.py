"""repro_torch.data — see the package docstring of repro_torch."""

"""repro_torch.core — see the package docstring of repro_torch."""

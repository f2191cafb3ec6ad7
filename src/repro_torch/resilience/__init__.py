"""repro_torch.resilience — see the package docstring of repro_torch."""

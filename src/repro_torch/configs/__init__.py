"""repro_torch.configs — see the package docstring of repro_torch."""

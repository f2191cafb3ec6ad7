"""repro_torch.training — see the package docstring of repro_torch."""

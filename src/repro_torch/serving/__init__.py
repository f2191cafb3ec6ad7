"""repro_torch.serving — the LM serving steps, engine and SLO accounting."""

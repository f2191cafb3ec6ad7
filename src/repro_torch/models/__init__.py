"""repro_torch.models — the LM side (dense transformer family)."""

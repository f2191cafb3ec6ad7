"""Placement of the fleet over a ``torch.distributed`` device mesh."""

"""Model configurations (dataclasses only, no tensors)."""

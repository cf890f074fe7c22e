"""The serial batched engine."""

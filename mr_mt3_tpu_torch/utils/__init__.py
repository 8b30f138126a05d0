"""Config loading, builders, checkpoint import, device selection."""

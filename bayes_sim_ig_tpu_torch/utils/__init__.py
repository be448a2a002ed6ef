"""Host utilities: CLI args and configs, collection, plots, weight
conversion."""

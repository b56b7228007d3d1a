"""Launch layer: drivers (the serving loop so far)."""

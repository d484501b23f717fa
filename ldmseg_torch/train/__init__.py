"""The port's trainer (sampling half)."""

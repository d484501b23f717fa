"""The port's training losses."""

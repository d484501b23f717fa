"""Configuration of the port."""

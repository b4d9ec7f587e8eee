"""Utilities of the port (logging)."""

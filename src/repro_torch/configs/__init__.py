"""Configurations of the port (the reference's widths)."""

"""Shallow-water operators of the port (see each module's docstring)."""

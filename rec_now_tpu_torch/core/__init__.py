"""Initializers and device resolution."""

"""Interaction layers."""

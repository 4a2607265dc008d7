"""Embedding storage."""

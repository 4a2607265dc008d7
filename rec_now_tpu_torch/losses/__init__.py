"""Losses the trainer calls (pointwise BCE, in-batch pairwise BPR)."""

"""Losses the trainer calls (pointwise BCE, in-batch pairwise BPR, in-batch
listwise softmax-CE)."""

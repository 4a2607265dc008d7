"""Losses: pointwise BCE, the in-batch pairwise BPR loss (``pairwise_loss``,
every option of the JAX kernel path) and the in-batch listwise
softmax-CE."""

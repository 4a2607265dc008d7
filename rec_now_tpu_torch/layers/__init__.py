"""Layers: interactions (CIN, inner-PNN) and the multitask banks (multi-
expert dense, MMoE, PLE, Parasitic STAR)."""

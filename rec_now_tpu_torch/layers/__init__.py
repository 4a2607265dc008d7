"""Layers: interactions (CIN, inner-PNN, SENET, DCN-mix) and the multitask
banks (multi-expert dense, MMoE, PLE, Parasitic STAR)."""

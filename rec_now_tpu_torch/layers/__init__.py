"""Layers: interactions (FM, CIN, inner-PNN, SENET, DCN-mix) and the
multitask banks (multi-expert dense, MMoE, PLE, Parasitic STAR)."""

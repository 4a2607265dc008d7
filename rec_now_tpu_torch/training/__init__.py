"""Host data and the request wire (numpy-only pieces of the JAX
``training`` package; no trainer yet)."""

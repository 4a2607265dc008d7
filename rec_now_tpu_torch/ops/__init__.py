"""Kernels (CUDA, built by ``_build``) and the ops that dispatch to them."""

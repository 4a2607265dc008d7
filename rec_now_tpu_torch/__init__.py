"""PyTorch / CUDA port of ``rec_now_tpu`` for NVIDIA Hopper (H100).

Covers xDeepFM serving today: feature layout, (V, D) embedding table,
CIN (hand-written CUDA kernels in ``csrc/cin.cu``), inner-PNN, DNN
tower, the request wire, and ``build_scorer`` / ``WireScorer`` /
``export_serving`` / ``load_serving``.  Entry points run on CUDA unless
the caller passes ``device="cpu"``; on the CPU every kernel wrapper
takes its plain PyTorch version.
"""

"""PyTorch / CUDA port of ``rec_now_tpu`` for NVIDIA Hopper (H100).

Covers xDeepFM serving and one-device training today: feature layout,
(V, D) embedding table with dense-apply row-wise Adagrad, CIN, inner-PNN,
DNN tower, the pointwise and in-batch pairwise losses, ``Trainer``, the
request wire, and ``build_scorer`` / ``WireScorer`` / ``export_serving`` /
``load_serving``; the Pallas TPU kernels on these paths are hand-written
CUDA kernels in ``csrc/`` (CIN forward and backward, the pair loss, the
Adagrad table pass).  Entry points run on CUDA unless
the caller passes ``device="cpu"``; on the CPU every kernel wrapper
takes its plain PyTorch version.
"""

"""PyTorch / CUDA port of ``rec_now_tpu`` for NVIDIA Hopper (H100).

Covers serving and one-device training of xDeepFM (config 3) and of the
MMoE + PLE + STAR multitask model (config 4) today: feature layout,
(V, D) embedding table with dense-apply row-wise Adagrad, CIN, inner-PNN,
DNN tower, the multi-expert dense, MMoE, PLE, the Parasitic STAR tower,
the pointwise and in-batch pairwise and listwise losses, ``Trainer``, the
request wire, and ``build_scorer`` / ``WireScorer`` / ``export_serving`` /
``load_serving``; the Pallas TPU kernels on these paths are hand-written
CUDA kernels in ``csrc/`` (CIN forward and backward, the multi-expert
dense, the pair and listwise losses, the Adagrad table pass).  Entry points run on CUDA unless
the caller passes ``device="cpu"``; on the CPU every kernel wrapper
takes its plain PyTorch version.
"""

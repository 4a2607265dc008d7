"""PyTorch / CUDA port of ``rec_now_tpu`` for NVIDIA Hopper (H100).

Covers serving and training, on one device or on one process per device
(``parallel/``: ``torch.distributed``, the tables mod-sharded over the
processes on the allgather or the routed exchange, ``embedding/
exchange.py``; checkpoints and the serving export from every process),
of FM (config 1), DCN-v2 + SENET
(config 2, with lazy sparse Adam on the rows), xDeepFM (config 3), the
MMoE + PLE + STAR multitask model (config 4) and CAN with DCN-v2
(config 5, with its second table of per-item CAN parameters) today:
feature layout, (V, D) embedding tables of any width with row-wise
Adagrad or lazy Adam (dense-apply or sparse), FM, SENET, DCN-mix, CIN,
inner-PNN, CAN, pooling, DNN tower, the multi-expert
dense, MMoE, PLE, the Parasitic STAR tower, the pointwise, in-batch
pairwise (the public ``pairwise_loss`` with every option of the JAX
kernel path) and listwise losses, ``Trainer`` with the windowed loop over
the compressed wire (bit-packed or hot8 ids), exact and device-resident
eval metrics, prefetching, checkpoints, Criteo-TSV ingestion on a native
parser (``io/``), the training CLI (``python -m rec_now_tpu_torch.train``,
on the synthetic stream or a data file), the debug, profiling and shape
helpers (``core/``, ``util/``),
and ``build_scorer`` / ``WireScorer`` / ``export_serving`` /
``load_serving``.  Every Pallas TPU kernel of the JAX package is a
hand-written CUDA kernel in ``csrc/`` (CIN forward and backward, the
multi-expert dense, the pair loss and its three counting kernels, the
listwise loss, the Adagrad and Adam table passes, the row gather and the
row scatter-add).  Entry points run on CUDA unless the caller passes
``device="cpu"``; on the CPU every kernel wrapper takes its plain
PyTorch version.
"""

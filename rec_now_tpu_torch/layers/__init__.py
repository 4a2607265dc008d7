"""Layers: interactions (FM, CIN, inner-PNN, SENET, DCN-mix, CAN), pooling
and the multitask banks (multi-expert dense, MMoE, PLE, Parasitic STAR)."""
from rec_now_tpu_torch.layers.can_layer import CANLayer  # noqa: F401
from rec_now_tpu_torch.layers.pooling_layer import (PoolingLayer,  # noqa: F401
                                                    pool)

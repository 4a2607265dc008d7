"""Layers, exported as ``rec_now_tpu/layers/__init__.py`` exports them:
interactions (FM, inner-PNN, CIN, SENET, DCN, DCN-mix, DCN-V2's low-rank
cross, CAN, the sparse field GNN), pooling and fixed length, the multitask banks (multi-expert
dense, MMoE, PLE), the personalized dense layers (STAR, stacked and their
parasitic forms) and the hash-trick layers (multi-hash, cartesian
crossing)."""
from rec_now_tpu_torch.layers.fm_layer import FMLayer  # noqa: F401
from rec_now_tpu_torch.layers.inner_pnn_layer import InnerPNNLayer  # noqa: F401
from rec_now_tpu_torch.layers.pooling_layer import (PoolingLayer,  # noqa: F401
                                                    pool)
from rec_now_tpu_torch.layers.fix_length_layer import FixLengthLayer  # noqa: F401
from rec_now_tpu_torch.layers.multi_dense_layer import MultiDenseLayer  # noqa: F401
from rec_now_tpu_torch.layers.dcn_layer import DCNLayer  # noqa: F401
from rec_now_tpu_torch.layers.dcn_mix_layer import DCNMixLayer  # noqa: F401
from rec_now_tpu_torch.layers.low_rank_cross_layer import (  # noqa: F401
    LowRankCrossLayer)
from rec_now_tpu_torch.layers.cin_layer import CINLayer  # noqa: F401
from rec_now_tpu_torch.layers.mmoe_layer import MMOELayer  # noqa: F401
from rec_now_tpu_torch.layers.ple_layer import PLELayer  # noqa: F401
from rec_now_tpu_torch.layers.senet_layer import SENETLayer  # noqa: F401
from rec_now_tpu_torch.layers.sparse_gnn_layer import SparseGNNLayer  # noqa: F401
from rec_now_tpu_torch.layers.star_dense_layer import (  # noqa: F401
    StarDenseLayer, ParasiticStarDenseLayer)
from rec_now_tpu_torch.layers.stacked_dense_layer import (  # noqa: F401
    StackedDenseLayer, ParasiticStackedDenseLayer)
from rec_now_tpu_torch.layers.can_layer import CANLayer  # noqa: F401
from rec_now_tpu_torch.layers.multi_hash_layer import (  # noqa: F401
    MultiHashLayer, FastMultiHashLayer)
from rec_now_tpu_torch.layers.cartesian_product_layer import (  # noqa: F401
    CartesianProductLayer)

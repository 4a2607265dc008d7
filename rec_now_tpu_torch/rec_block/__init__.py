"""Recommendation blocks: target attention, per-element weights and the
slot / segment embedding utilities, as ``rec_now_tpu/rec_block`` has
them (``embedding_util``'s functions take an ``embedding_func``, such as
``EmbeddingTable.embedding_func``)."""
from rec_now_tpu_torch.rec_block.attention import (  # noqa: F401
    DNNAttention, attention_by_dnn, attention_by_dot_product)
from rec_now_tpu_torch.rec_block.embedding_wise_weight import (  # noqa: F401
    gather_embedding_element_wise_weight)
from rec_now_tpu_torch.rec_block import embedding_util  # noqa: F401

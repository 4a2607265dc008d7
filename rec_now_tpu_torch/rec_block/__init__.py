"""Recommendation blocks: target attention and per-element weights, the
part of ``rec_now_tpu/rec_block`` this package has (its
``embedding_util`` comes with the table's ``embedding_func``)."""
from rec_now_tpu_torch.rec_block.attention import (  # noqa: F401
    DNNAttention, attention_by_dnn, attention_by_dot_product)
from rec_now_tpu_torch.rec_block.embedding_wise_weight import (  # noqa: F401
    gather_embedding_element_wise_weight)

"""Losses: pointwise BCE, the in-batch pairwise loss (``pairwise_loss``,
with its blocked form), the in-batch listwise softmax-CE (with its blocked
form) and the focal loss, as ``rec_now_tpu/losses/__init__.py`` exports
them."""
from rec_now_tpu_torch.losses.pairwise import (  # noqa: F401
    pairwise_loss,
    generate_pair_mask,
    bpr_loss_func,
    occurance_power_weight,
)
from rec_now_tpu_torch.losses.listwise import (  # noqa: F401
    to_listwise_sample,
    listwise_loss_via_softmax_cross_entropy_with_logits,
    listwise_loss,
)
from rec_now_tpu_torch.losses.focal import focal_crossentropy_loss  # noqa: F401
from rec_now_tpu_torch.losses.pointwise import (  # noqa: F401
    sigmoid_cross_entropy_with_logits,
    bce_loss,
)

"""Parameter normalization helpers (counterpart of
``rec_now_tpu/util/param_normalizer.py``)."""
from rec_now_tpu_torch.core.shapes import wrap_as_list  # noqa: F401

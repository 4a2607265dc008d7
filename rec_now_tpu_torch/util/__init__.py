"""Small helpers: list wrapping and numpy comparisons (counterpart of
``rec_now_tpu/util/``)."""
from rec_now_tpu_torch.util.param_normalizer import wrap_as_list  # noqa: F401
from rec_now_tpu_torch.util.numpy_tools import (  # noqa: F401
    calc_sum_of_abs_diff, all_equal)

"""Model families ported so far."""
from rec_now_tpu_torch.models.feature_config import FeatureConfig  # noqa: F401
from rec_now_tpu_torch.models.tower import DNNTower  # noqa: F401
from rec_now_tpu_torch.models.xdeepfm_model import XDeepFMModel  # noqa: F401

"""Model families ported so far."""
from rec_now_tpu_torch.models.can_dcn_model import CANDCNModel  # noqa: F401
from rec_now_tpu_torch.models.dcn_model import DCNv2Model  # noqa: F401
from rec_now_tpu_torch.models.dlrm_dcnv2_model import DLRMDCNv2Model  # noqa: F401
from rec_now_tpu_torch.models.feature_config import FeatureConfig  # noqa: F401
from rec_now_tpu_torch.models.fm_model import FMModel  # noqa: F401
from rec_now_tpu_torch.models.multitask_model import MultiTaskModel  # noqa: F401
from rec_now_tpu_torch.models.ple_model import PLEModel  # noqa: F401
from rec_now_tpu_torch.models.tower import DNNTower  # noqa: F401
from rec_now_tpu_torch.models.xdeepfm_model import XDeepFMModel  # noqa: F401

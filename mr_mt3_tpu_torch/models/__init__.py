"""MT3 model family in PyTorch (vanilla)."""

from mr_mt3_tpu_torch.models.config import MT3Config, config_from_dict
from mr_mt3_tpu_torch.models.mt3 import MT3

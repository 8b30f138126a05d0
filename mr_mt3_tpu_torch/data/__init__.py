"""Dataset pipelines (copies of mr_mt3_tpu.data: host-side tokenization;
the mel runs on the device in the train step)."""

from mr_mt3_tpu_torch.data.slakh import (
    SlakhDataset,
    SlakhDatasetWithPrevSegmem,
    SlakhDatasetWithPrevSegmemAugment,
)
from mr_mt3_tpu_torch.data.commu import ComMUDataset
from mr_mt3_tpu_torch.data.loader import DataLoader, collate_batch

"""Dataset registry + builders (dcpt_tpu/data/__init__.py).

Loading is ``torch.utils.data.DataLoader``, which takes the place of
``dcpt_tpu/data/dataloader.py``.
"""

from copy import deepcopy

from torch.utils.data import DataLoader

from ..utils.logger import get_root_logger
from ..utils.registry import DATASET_REGISTRY
from . import paired_image_dataset  # noqa: F401  (registers the datasets)

__all__ = ["build_dataset", "build_dataloader"]


def build_dataset(dataset_opt: dict):
    dataset_opt = deepcopy(dataset_opt)
    dataset = DATASET_REGISTRY.get(dataset_opt["type"])(dataset_opt)
    get_root_logger().info(f'Dataset [{dataset.__class__.__name__}] - {dataset_opt["name"]} is built.')
    return dataset


def build_dataloader(dataset, dataset_opt: dict) -> DataLoader:
    """The test-phase loader: batch 1, in order, in this process (reference: data/__init__.py:50-118)."""
    phase = dataset_opt["phase"]
    if phase != "test":
        raise NotImplementedError(f"dcpt_tpu_torch builds test-phase loaders only (got phase {phase!r})")
    return DataLoader(dataset, batch_size=1, shuffle=False, num_workers=0)

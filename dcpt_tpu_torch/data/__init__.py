"""Dataset registry + builders (dcpt_tpu/data/__init__.py).

Loading is ``torch.utils.data.DataLoader``, which takes the place of dcpt_tpu's
own loader in ``dcpt_tpu/data/dataloader.py``.
"""

from copy import deepcopy
from functools import partial

from torch.utils.data import DataLoader

from ..utils.logger import get_root_logger
from ..utils.registry import DATASET_REGISTRY
from . import paired_image_dataset  # noqa: F401  (registers the datasets)
from .concat_dataset import ConcatDataset
from .data_sampler import EnlargedSampler
from .dataloader import CPUPrefetcher, CUDAPrefetcher, worker_init_fn

__all__ = ["build_dataset", "build_dataloader", "ConcatDataset", "EnlargedSampler", "CPUPrefetcher",
           "CUDAPrefetcher"]


def build_dataset(dataset_opt: dict):
    dataset_opt = deepcopy(dataset_opt)
    dataset = DATASET_REGISTRY.get(dataset_opt["type"])(dataset_opt)
    get_root_logger().info(f'Dataset [{dataset.__class__.__name__}] - {dataset_opt["name"]} is built.')
    return dataset


def build_dataloader(dataset, dataset_opt: dict, num_gpu: int = 1, sampler=None, seed=None,
                     pin_memory: bool = False) -> DataLoader:
    """The phase's loader (reference: data/__init__.py:50-118), one process.

    train: ``batch_size_per_gpu`` and ``num_worker_per_gpu`` times the device
    count, the sampler's order, ``drop_last``, seeded workers (and, as in
    dcpt_tpu, this process seeded with worker 0's seed).  val: the same, in
    order.  test: batch 1, in order, in this process."""
    phase = dataset_opt["phase"]
    if phase in ("train", "val"):
        multiplier = 1 if num_gpu == 0 else num_gpu
        num_workers = dataset_opt["num_worker_per_gpu"] * multiplier
        init = None
        if seed is not None:
            worker_init_fn(0, num_workers, 0, seed)
            init = partial(worker_init_fn, num_workers=num_workers, rank=0, seed=seed)
        return DataLoader(dataset, batch_size=dataset_opt["batch_size_per_gpu"] * multiplier,
                          shuffle=sampler is None and phase == "train", sampler=sampler, drop_last=True,
                          num_workers=num_workers, worker_init_fn=init, pin_memory=pin_memory,
                          persistent_workers=False)
    if phase == "test":
        return DataLoader(dataset, batch_size=1, shuffle=False, num_workers=0)
    raise ValueError(f"Wrong dataset phase: {phase}. Supported ones are 'train', 'val' and 'test'.")

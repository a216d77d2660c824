"""Worker seeding and prefetchers (dcpt_tpu/data/dataloader.py).

Loading itself is ``torch.utils.data.DataLoader``.  Its workers are seeded
with the reference's rule ``num_workers * rank + worker_id + seed``
(``basicsr/data/__init__.py:121-125``).  ``CPUPrefetcher`` hands the loader's
batches on as they are; ``CUDAPrefetcher`` takes the place of dcpt_tpu's
``DevicePrefetcher``: it copies the next batch to the card on a side stream
while the current step runs (reference ``prefetch_dataloader.py:83-125``).
"""

from __future__ import annotations

import random

import numpy as np
import torch


def worker_init_fn(worker_id: int, num_workers: int, rank: int, seed: int) -> None:
    """Seed numpy and python ``random`` with num_workers * rank + worker_id + seed."""
    worker_seed = num_workers * rank + worker_id + seed
    np.random.seed(worker_seed)
    random.seed(worker_seed)


class CPUPrefetcher:
    """The loader's batches, one ``next()`` at a time; None at the end of the epoch."""

    def __init__(self, loader):
        self.loader = iter(loader)

    def next(self):
        return next(self.loader, None)


class CUDAPrefetcher:
    """The next batch's tensors go to ``device`` on a side stream, so the copy
    overlaps the step that runs on the current stream."""

    def __init__(self, loader, device: torch.device):
        self.ori_loader = loader
        self.device = device
        self.stream = torch.cuda.Stream(device=device)
        self.reset()

    def _preload(self) -> None:
        self.batch = next(self.loader, None)
        if self.batch is None:
            return
        with torch.cuda.stream(self.stream):
            for k, v in self.batch.items():
                if torch.is_tensor(v):
                    self.batch[k] = v.to(self.device, non_blocking=True)

    def next(self):
        current = torch.cuda.current_stream(self.device)
        current.wait_stream(self.stream)
        batch = self.batch
        if batch is not None:
            for v in batch.values():
                if torch.is_tensor(v):
                    v.record_stream(current)
        self._preload()
        return batch

    def reset(self) -> None:
        self.loader = iter(self.ori_loader)
        self._preload()

"""EnlargedSampler (dcpt_tpu/data/data_sampler.py, reference ``basicsr/data/data_sampler.py:7-50``).

An epoch-seeded permutation of the enlarged index space, mapped onto the
dataset modulo its length, every ``num_replicas``-th index from ``rank``.
The default order is numpy's ``default_rng(epoch).permutation``, dcpt_tpu's;
``torch_compat`` gives the reference's ``torch.randperm`` order.
"""

from __future__ import annotations

import math

import numpy as np
import torch


class EnlargedSampler(torch.utils.data.Sampler):
    def __init__(self, dataset, num_replicas: int, rank: int, ratio: int = 1, torch_compat: bool = False):
        self.dataset = dataset
        self.num_replicas = num_replicas
        self.rank = rank
        self.epoch = 0
        self.torch_compat = torch_compat
        self.num_samples = math.ceil(len(dataset) * ratio / num_replicas)
        self.total_size = self.num_samples * num_replicas

    def __iter__(self):
        if self.torch_compat:
            g = torch.Generator()
            g.manual_seed(self.epoch)
            indices = torch.randperm(self.total_size, generator=g).numpy()
        else:
            indices = np.random.default_rng(self.epoch).permutation(self.total_size)
        indices = (indices % len(self.dataset))[self.rank : self.total_size : self.num_replicas]
        return iter(indices.tolist())

    def __len__(self):
        return self.num_samples

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

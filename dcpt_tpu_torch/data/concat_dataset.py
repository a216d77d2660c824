"""ConcatDataset with per-dataset enlarge ratios and ``dataset_idx`` stamping
(dcpt_tpu/data/concat_dataset.py, reference ``basicsr/data/concat_dataset.py:42-102``).

``dataset_idx``, which sub-dataset (degradation type) a sample came from, is
the label every DCPT model trains its classifier on.
"""

from __future__ import annotations

import bisect
from typing import Iterable, Sequence


class ConcatDataset:
    def __init__(self, datasets: Iterable, enlarge_ratios: Sequence[int]):
        self.datasets = list(datasets)
        self.enlarge_ratios = list(enlarge_ratios)
        if not self.datasets:
            raise ValueError("datasets should not be an empty iterable")
        if len(self.datasets) != len(self.enlarge_ratios):
            raise ValueError(f"The numbers of datasets is not the same as the numbers of enlarge_ratios, "
                             f"{len(self.datasets)} v.s. {len(self.enlarge_ratios)}.")
        self.datasets_length = [len(d) for d in self.datasets]
        self.cumulative_sizes = []
        total = 0
        for length, ratio in zip(self.datasets_length, self.enlarge_ratios):
            total += length * ratio
            self.cumulative_sizes.append(total)

    def __len__(self):
        return self.cumulative_sizes[-1]

    def __getitem__(self, idx):
        if idx < 0:
            if -idx > len(self):
                raise ValueError("absolute value of index should not exceed dataset length")
            idx = len(self) + idx
        dataset_idx = bisect.bisect_right(self.cumulative_sizes, idx)
        start = self.cumulative_sizes[dataset_idx - 1] if dataset_idx else 0
        data = self.datasets[dataset_idx][(idx - start) % self.datasets_length[dataset_idx]]
        data["dataset_idx"] = dataset_idx
        return data

"""Data loading (port of deepspeed_tpu/runtime/dataloader.py):
DeepSpeedDataLoader and RepeatingLoader over numpy-array dicts,
indexable datasets (torch datasets included) or any sized dataset. Each
data-parallel rank loads its contiguous slice of the dataset; the
engine moves the collated batch to the device. At world size 1 (this
slice) the slice is the whole dataset.
"""

import math

import numpy as np


class RepeatingLoader:
    """Wrap an iterator to restart on StopIteration (ref dataloader.py:10)."""

    def __init__(self, loader):
        self.loader = loader
        self.data_iter = iter(self.loader)

    def __iter__(self):
        return self

    def __next__(self):
        try:
            batch = next(self.data_iter)
        except StopIteration:
            self.data_iter = iter(self.loader)
            batch = next(self.data_iter)
        return batch


def _default_collate(samples):
    """Stack a list of samples (dicts of arrays / arrays / tuples)."""
    first = samples[0]
    if isinstance(first, dict):
        return {k: np.stack([np.asarray(s[k]) for s in samples])
                for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(
            np.stack([np.asarray(s[i]) for s in samples])
            for i in range(len(first)))
    return np.stack([np.asarray(s) for s in samples])


class DeepSpeedDataLoader:
    def __init__(self,
                 dataset,
                 batch_size,
                 local_rank=0,
                 tput_timer=None,
                 collate_fn=None,
                 num_local_io_workers=None,
                 data_sampler=None,
                 data_parallel_world_size=1,
                 data_parallel_rank=0,
                 shuffle=False,
                 seed=0,
                 drop_last=True):
        self.dataset = dataset
        self.batch_size = batch_size
        self.tput_timer = tput_timer
        self.collate_fn = collate_fn or _default_collate
        self.dp_world_size = data_parallel_world_size
        self.dp_rank = data_parallel_rank
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.epoch = 0

        self._length = self._compute_length()

    def _dataset_len(self):
        if hasattr(self.dataset, "__len__"):
            return len(self.dataset)
        raise TypeError("dataset must be sized for DeepSpeedDataLoader")

    def _compute_length(self):
        n = self._dataset_len()
        per_rank = n // self.dp_world_size if self.drop_last else \
            math.ceil(n / self.dp_world_size)
        if self.drop_last:
            return per_rank // self.batch_size
        return math.ceil(per_rank / self.batch_size)

    def __len__(self):
        return self._length

    def set_epoch(self, epoch):
        self.epoch = epoch

    def _indices(self):
        n = self._dataset_len()
        if self.shuffle:
            rng = np.random.RandomState(self.seed + self.epoch)
            order = rng.permutation(n)
        else:
            order = np.arange(n)
        # contiguous per-rank shard (each process loads only its slice)
        per_rank = n // self.dp_world_size if self.drop_last else \
            math.ceil(n / self.dp_world_size)
        start = self.dp_rank * per_rank
        return order[start:start + per_rank]

    def __iter__(self):
        indices = self._indices()
        nb = self._length
        for b in range(nb):
            if self.tput_timer:
                self.tput_timer.start()
            idx = indices[b * self.batch_size:(b + 1) * self.batch_size]
            samples = [self.dataset[int(i)] for i in idx]
            yield self.collate_fn(samples)
        self.epoch += 1

"""Deterministic, resumable weighted multi-bucket sampling.

Port copy of `simlingo_tpu/data/sampler.py` (`normalize_buckets` :28,
`WeightedBucketSampler` :52).

Counterpart of the reference's WeightedRandomSampler over a ConcatDataset of
per-bucket datasets (datamodule.py:159-253): per-bucket weights from the
train-partition yaml, driving vs dreamer weighted 50/50, epoch length
num_samples = min_b(len_b / w_b).

TPU redesign (SURVEY.md hard part #5): the reference's sampler state lives in
forked torch workers and cannot be checkpointed; ours is a pure function of
(seed, step) -- `sample_at(step)` -- so resume is exact after preemption.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class Bucket:
    name: str
    size: int          # number of samples in this bucket
    weight: float      # relative sampling weight


def normalize_buckets(driving: Dict[str, Tuple[int, float]],
                      dreamer: Optional[Dict[str, Tuple[int, float]]] = None,
                      driving_fraction: float = 0.5) -> List[Bucket]:
    """Build the bucket list with the reference's weighting scheme:
    within-group weights normalized to 1, groups mixed 50/50 when both
    exist (datamodule.py:175-196). Empty buckets are dropped."""
    out: List[Bucket] = []

    def add(group: Dict[str, Tuple[int, float]], frac: float, suffix: str):
        items = [(n, s, w) for n, (s, w) in group.items() if s > 0]
        total_w = sum(w for _, _, w in items)
        if total_w <= 0:
            return
        for name, size, w in items:
            out.append(Bucket(name + suffix, size, frac * w / total_w))

    if dreamer:
        add(driving, driving_fraction, "")
        add(dreamer, 1.0 - driving_fraction, "_dreamer")
    else:
        add(driving, 1.0, "")
    return out


class WeightedBucketSampler:
    """sample_at(step) -> (bucket_idx, index_within_bucket).

    Stateless w.r.t. iteration: any step id maps deterministically to a
    sample, so data order is reproducible and resumable from a step counter
    alone (the training checkpoint stores only `step`).
    """

    def __init__(self, buckets: Sequence[Bucket], seed: int = 0):
        assert buckets, "no non-empty buckets"
        self.buckets = list(buckets)
        self.seed = seed
        w = np.asarray([b.weight for b in self.buckets], np.float64)
        self.probs = w / w.sum()
        self.cum = np.cumsum(self.probs)
        # reference epoch length: min over buckets of len_b / w_b
        self.num_samples = int(min(
            b.size / p for b, p in zip(self.buckets, self.probs)))

    def sample_at(self, step: int) -> Tuple[int, int]:
        rng = np.random.RandomState(
            (self.seed * 1_000_003 + step) % (2 ** 31 - 1))
        u = rng.rand()
        b = int(np.searchsorted(self.cum, u, side="right"))
        b = min(b, len(self.buckets) - 1)
        idx = rng.randint(self.buckets[b].size)
        return b, idx

    def batch_at(self, step: int, batch_size: int) -> List[Tuple[int, int]]:
        return [self.sample_at(step * batch_size + i)
                for i in range(batch_size)]

"""Sequential validation subsets (host-side).

Counterpart of `e2e_multi_view_matching_tpu/data/sampling.py`: validation
walks through contiguous index ranges of at least ~60k samples, one range an
epoch, so that each pass is bounded and the whole set is covered over epochs.
"""

import numpy as np


def compute_samples_per_subset(sample_count, at_least_n):
    at_least_n = min(at_least_n, sample_count)
    number_subsets = int(sample_count / at_least_n)
    samples_per_subset = int(sample_count / number_subsets)
    extra_sample_subsets = sample_count % samples_per_subset
    normal_subsets = number_subsets - extra_sample_subsets
    return samples_per_subset, normal_subsets, extra_sample_subsets


def create_sequential_subsets(sample_count, at_least_n):
    """Split range(sample_count) into contiguous index arrays."""
    per, normal, extra = compute_samples_per_subset(sample_count, at_least_n)
    subsets = []
    idx = 0
    for _ in range(normal):
        subsets.append(np.arange(idx, idx + per))
        idx += per
    for _ in range(extra):
        subsets.append(np.arange(idx, idx + per + 1))
        idx += per + 1
    return subsets

"""Seeds of a run: one `--seed` gives every generator its own stream."""

import hashlib


def derive(seed, purpose):
    """A 63-bit seed for `purpose` (a short name) from the run's `--seed`,
    any whole number: the same pair gives the same seed, and two purposes
    give unrelated ones."""
    digest = hashlib.sha256(f"{int(seed)}:{purpose}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def generator(seed, purpose, device):
    """A `torch.Generator` on `device` seeded by `derive(seed, purpose)`."""
    import torch

    return torch.Generator(device=device).manual_seed(derive(seed, purpose))

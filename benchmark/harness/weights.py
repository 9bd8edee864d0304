"""Seeded weights of a model, drawn on the device in one call.

The benchmark makes the weights and hands the same tensors to the program
and to the reference, which load them by name. Kernels of linear and
convolution layers (every `weight` of two or more dimensions) are LeCun
normal, N(0, 1 / fan_in), as flax draws them by default; biases are 0;
BatchNorm scales 1, shifts 0, running means 0 and variances 1; the dustbin
score `bin_score` 1. All kernels come from one `torch.randn` on the
generator's device, split in the order of the state dict.
"""

import torch


def draw(shapes, generator, device):
    """{name: tensor} for `shapes`, an ordered {name: (shape, dtype)} as a
    module's state dict gives them (see `state_shapes`)."""
    kernels = [n for n, (shape, _) in shapes.items() if n.endswith("weight") and len(shape) >= 2]
    sizes = [_numel(shapes[n][0]) for n in kernels]
    flat = torch.randn(sum(sizes), generator=generator, device=device)
    out, lo = {}, 0
    for name, size in zip(kernels, sizes):
        shape = shapes[name][0]
        fan_in = _numel(shape[1:])
        out[name] = flat[lo:lo + size].reshape(shape) * fan_in ** -0.5
        lo += size
    for name, (shape, dtype) in shapes.items():
        if name in out:
            continue
        if name.endswith("running_var") or name == "bin_score" or name.endswith("weight"):
            out[name] = torch.ones(shape, dtype=dtype, device=device)
        else:  # biases, BatchNorm shifts, running means, num_batches_tracked
            out[name] = torch.zeros(shape, dtype=dtype, device=device)
    return {n: out[n] for n in shapes}


def state_shapes(module):
    """{name: (shape, dtype)} of `module`'s state dict, in its order; the
    module may live on the meta device."""
    return {n: (tuple(t.shape), t.dtype) for n, t in module.state_dict().items()}


def _numel(shape):
    n = 1
    for s in shape:
        n *= s
    return n

"""Weight bridge between flax variables of the JAX package and the port's state dicts.

`state_dict_from_flax` takes the variables of the JAX `SuperPoint` or
`MultiViewMatcher` as nested dicts of numpy arrays (`params` and, for the
matcher, `batch_stats`) and returns a state dict that the port's module of the
same name loads with `strict=True`. The port's submodule names follow the
flax names, so the map is mechanical:

- Dense `kernel` (in, out) -> Linear `weight` (out, in);
- Conv `kernel` HWIO -> Conv2d `weight` OIHW;
- BatchNorm `scale`/`bias` -> `weight`/`bias`, `batch_stats` `mean`/`var` ->
  `running_mean`/`running_var` (+ `num_batches_tracked` = 0);
- `bin_score` -> the scalar parameter of the same name.

`flax_from_state_dict` is the inverse: a state dict, or any dict keyed like
one (the gradients by parameter name of a train step), becomes flax-shaped
`{"params": ..., "batch_stats": ...}` trees of numpy arrays, so that gradients
and running statistics compare leaf by leaf with the JAX package's.

`init_like_flax_` draws a module's weights as flax's default initializers do,
for runs that start from scratch.
"""

import numpy as np
import torch


def _walk(tree, prefix=()):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _walk(value, prefix + (key,))
        else:
            yield prefix + (key,), np.asarray(value)


def state_dict_from_flax(variables):
    """Map flax `{"params": ..., "batch_stats": ...}` to a torch state dict."""
    out = {}
    for path, arr in _walk(variables.get("params", {})):
        *mod, leaf = path
        name = ".".join(mod)
        if leaf == "kernel":
            if arr.ndim == 2:  # Dense (in, out) -> Linear (out, in)
                arr = arr.T
            elif arr.ndim == 4:  # Conv HWIO -> OIHW
                arr = arr.transpose(3, 2, 0, 1)
            else:
                raise ValueError(f"unexpected kernel rank at {'/'.join(path)}")
            out[f"{name}.weight"] = arr
        elif leaf == "scale":  # BatchNorm
            out[f"{name}.weight"] = arr
        elif leaf == "bias":
            out[f"{name}.bias"] = arr
        elif leaf == "bin_score" and not mod:
            out["bin_score"] = arr
        else:
            raise ValueError(f"unmapped flax parameter {'/'.join(path)}")
    for path, arr in _walk(variables.get("batch_stats", {})):
        *mod, leaf = path
        name = ".".join(mod)
        if leaf == "mean":
            out[f"{name}.running_mean"] = arr
            out[f"{name}.num_batches_tracked"] = np.zeros((), np.int64)
        elif leaf == "var":
            out[f"{name}.running_var"] = arr
        else:
            raise ValueError(f"unmapped flax batch statistic {'/'.join(path)}")
    return {k: torch.from_numpy(np.array(v)) for k, v in out.items()}


def flax_from_state_dict(state_dict):
    """Map a torch state dict (or a dict keyed like one) to flax-shaped
    `{"params": nested, "batch_stats": nested}` trees of numpy arrays."""
    out = {"params": {}, "batch_stats": {}}

    def put(collection, mod, leaf, arr):
        node = out[collection]
        for part in mod:
            node = node.setdefault(part, {})
        node[leaf] = arr

    for key, value in state_dict.items():
        arr = value.detach().cpu().numpy() if isinstance(value, torch.Tensor) else np.asarray(value)
        *mod, leaf = key.split(".")
        if leaf == "num_batches_tracked":
            continue
        if leaf == "running_mean":
            put("batch_stats", mod, "mean", arr)
        elif leaf == "running_var":
            put("batch_stats", mod, "var", arr)
        elif leaf == "bias":
            put("params", mod, "bias", arr)
        elif leaf == "bin_score" and not mod:
            out["params"]["bin_score"] = arr
        elif leaf == "weight" and arr.ndim == 1:  # BatchNorm
            put("params", mod, "scale", arr)
        elif leaf == "weight" and arr.ndim == 2:  # Linear (out, in) -> Dense (in, out)
            put("params", mod, "kernel", arr.T)
        elif leaf == "weight" and arr.ndim == 4:  # Conv2d OIHW -> HWIO
            put("params", mod, "kernel", arr.transpose(2, 3, 1, 0))
        else:
            raise ValueError(f"unmapped state-dict entry {key}")
    return out


@torch.no_grad()
def init_like_flax_(module, generator):
    """Re-draw `module`'s weights in place as flax initializes by default:
    LeCun-normal Dense/Conv kernels, zero biases, BatchNorm scale 1, bias 0,
    mean 0, var 1; `generator` is a CPU `torch.Generator`. Returns `module`."""
    for m in module.modules():
        if isinstance(m, (torch.nn.Linear, torch.nn.Conv2d)):
            fan_in = m.weight[0].numel()
            m.weight.copy_(torch.randn(m.weight.shape, generator=generator) * fan_in ** -0.5)
            m.bias.zero_()
        elif isinstance(m, torch.nn.BatchNorm1d):
            m.reset_parameters()
    return module

"""SLAM-state snapshot and resume (counterpart of the JAX package's
utils/snapshot.py): any state built of dataclasses (FrameState and the
types of core/types.py) whose leaves are tensors or Python numbers.

The file is the JAX package's layout: one array a leaf, `leaf_{i}` in
depth-first field order, so a port state reads the leaves of a JAX
FrameState file that precede its RANSAC key (the port's carry has none;
its sampler draws). Every array goes to the host in the save and back to
its template leaf's device and dtype in the load.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def _leaves(tree):
    if dataclasses.is_dataclass(tree):
        for f in dataclasses.fields(tree):
            yield from _leaves(getattr(tree, f.name))
    else:
        yield tree


def save_state(state, path: str) -> None:
    """Write every leaf of `state` to one compressed npz."""
    arrays = {f"leaf_{i}": (x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
                            else np.asarray(x))
              for i, x in enumerate(_leaves(state))}
    np.savez_compressed(path, **arrays)


def load_state(template, path: str):
    """A state of `template`'s structure (same config and shapes) with the
    leaves of the file at `path`."""
    with np.load(path) as data:
        counter = iter(range(len(data.files)))

        def build(ref):
            if dataclasses.is_dataclass(ref):
                return dataclasses.replace(ref, **{f.name: build(getattr(ref, f.name))
                                                   for f in dataclasses.fields(ref)})
            arr = data[f"leaf_{next(counter)}"]
            if isinstance(ref, torch.Tensor):
                if tuple(arr.shape) != tuple(ref.shape):
                    raise ValueError(f"snapshot leaf of shape {arr.shape}, expected "
                                     f"{tuple(ref.shape)}")
                return torch.as_tensor(arr).to(device=ref.device, dtype=ref.dtype)
            return type(ref)(arr)

        return build(template)

"""Shared helpers for the jaxlsq_torch parity tests: carry JAX arrays, flax
structs and PackedWeights across to the port as numpy."""

import dataclasses

import numpy as np

from jaxlsq.serve.pack import PackedWeight as JaxPacked


def np_tree(tree):
    """A JAX variables tree as nested dicts of numpy arrays; a PackedWeight
    becomes the dict of its fields, other flax structs the dict of theirs."""
    if isinstance(tree, dict):
        return {k: np_tree(v) for k, v in tree.items()}
    if isinstance(tree, JaxPacked):
        return {f.name: (np.asarray(getattr(tree, f.name))
                         if f.name in ("data", "scale", "zero_point")
                         else getattr(tree, f.name))
                for f in dataclasses.fields(tree)}
    if dataclasses.is_dataclass(tree):
        return {f.name: np_tree(getattr(tree, f.name))
                for f in dataclasses.fields(tree)}
    return np.array(tree)


def torch_tree_to_np(tree):
    """The port's converted tree (tensors and PackedWeights) as numpy."""
    import torch

    if isinstance(tree, dict):
        return {k: torch_tree_to_np(v) for k, v in tree.items()}
    if dataclasses.is_dataclass(tree):
        return {f.name: torch_tree_to_np(getattr(tree, f.name))
                for f in dataclasses.fields(tree)}
    if torch.is_tensor(tree):
        return tree.numpy()
    return tree

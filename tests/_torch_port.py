"""Shared helpers for the jaxlsq_torch parity tests: carry JAX arrays, flax
structs and PackedWeights across to the port as numpy, walk variables
trees, and hand a JAX step's activation-quantizer outputs over to the port
where a rounding boundary fell the other way."""

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


def leaves(tree, prefix=()):
    """``(path, numpy leaf)`` of a nested dict."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves(v, prefix + (k,))
    else:
        yield prefix, np.asarray(tree)


def get_path(tree, path):
    for k in path:
        tree = tree[k]
    return tree


class Recorder:
    """Records each JAX activation quantizer's output while a jitted step
    runs (in call order: a scanned microbatch step calls each quantizer once
    per microbatch), and hands it to the port's matching quantizer where a
    rounding boundary fell the other way: where the two differ by more than
    half a quant step it checks that they differ by at most one (plus 1e-5
    of a step), counts the element and returns JAX's value."""

    def __init__(self):
        self.jax_out = {}
        self.moved = 0
        self.total = 0

    def intercept(self, next_fun, args, kwargs, context):
        import jax

        from jaxlsq.models.layers import FakeQuantize as JFakeQuantize

        out = next_fun(*args, **kwargs)
        mod = context.module
        if isinstance(mod, JFakeQuantize) and mod.name == "act_fq":
            path = "/".join(mod.path)
            jax.debug.callback(
                lambda v, p=path: self.jax_out.setdefault(p, []).append(np.asarray(v)),
                out, ordered=True)
        return out

    def hook(self, path):
        import torch

        def fn(mod, inputs, out):
            want = self.jax_out[path].pop(0)
            if want.ndim == 4:
                want = want.transpose(0, 3, 1, 2)  # NHWC -> NCHW
            d = torch.from_numpy(np.array(want)) - out.detach()
            step = float(mod.scale.detach().abs().max())
            moved = d.abs() > 0.5 * step
            assert float(d.abs().max()) <= step * (1 + 1e-5), (path, float(d.abs().max()), step)
            self.moved += int(moved.sum())
            self.total += out.numel()
            return out + torch.where(moved, d, torch.zeros_like(d))
        return fn

    def attach(self, model):
        """Hook every activation quantizer of the port's ``model``; returns
        the handles."""
        from jaxlsq_torch.models.layers import FakeQuantize

        return [mod.register_forward_hook(self.hook(name.replace(".", "/")))
                for name, mod in model.named_modules()
                if isinstance(mod, FakeQuantize) and name.endswith("act_fq")]

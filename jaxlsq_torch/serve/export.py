"""Ahead-of-time export of serving programs (port of ``jaxlsq/serve/export.py``).

The JAX package serializes its jitted serving program as a versioned
StableHLO artifact; the port serializes a ``torch.export`` program
(``torch.export.export(..., strict=False)``, saved with
``torch.export.save`` and its archive's entries deflated).  The serving
kernels are ``torch.library`` operators (``serve.custom_ops``), so the
program calls them by name:

* Weights are ARGUMENTS, as in the JAX package: the deployed callable is
  ``load_exported(blob)(state, x)`` with ``state`` the serve-mode model's
  ``state_dict()``.  The program is traced from a copy of the model on the
  ``meta`` device whose parameters and buffers are all replaced by
  ``state`` (``torch.func.functional_call``), so the artifact holds no
  weight and a weight update needs no new export.
* The program pins the calling convention: the state's keys, every shape
  and dtype; a call with another shape raises.
* The loading process needs ``torch`` and ``jaxlsq_torch.serve.custom_ops``
  (which registers the operators), not the model classes.  There is no
  ``platforms`` argument: a program runs on the device it was exported for.

:func:`export_generate` exports the greedy generate loop (prefill, then
``n_new - 1`` decode steps, every cache layout of ``init_kv_cache``) as one
program, unrolled: positions are Python ints, as in ``make_generate``.
"""

from __future__ import annotations

import copy
import io
import zipfile
from typing import Callable, Dict

import torch
from torch import nn

from . import custom_ops  # noqa: F401  (the operators the programs call)
from .decode import make_generate

__all__ = ["export_serving_forward", "export_generate", "load_exported",
           "save_exported_file", "load_exported_file"]


class _Program(nn.Module):
    """``fn(model, x)`` as a module whose only submodule is ``model``."""

    def __init__(self, model: nn.Module, fn: Callable):
        super().__init__()
        self.model = model
        self.fn = fn

    def forward(self, x):
        return self.fn(self.model, x)


class _WeightsAsArguments(nn.Module):
    """``(state, x) -> fn(model, x)`` with ``model``'s every parameter and
    buffer taken from ``state``.  The program is held outside the module's
    registry (a plain attribute, on the meta device), so the export lifts no
    tensor of it."""

    def __init__(self, program: _Program):
        super().__init__()
        self.__dict__["program"] = program

    def forward(self, state: Dict[str, torch.Tensor], x):
        return torch.func.functional_call(
            self.program, {f"model.{k}": v for k, v in state.items()}, (x,), strict=True)


def _export(model: nn.Module, fn: Callable, state, sample) -> bytes:
    if model.training:
        raise ValueError("export a model in eval mode (model.eval())")
    meta = copy.deepcopy(model).to("meta")
    wrapped = _WeightsAsArguments(_Program(meta, fn))
    state = dict(state)
    with torch.no_grad():
        ep = torch.export.export(wrapped, (state, sample), strict=False)
    ep._example_inputs = None  # the example state is the weights: not saved
    buf = io.BytesIO()
    torch.export.save(ep, buf)
    return _deflated(buf.getvalue())


def _deflated(archive: bytes) -> bytes:
    """The ``torch.export.save`` archive with its entries deflated (the graph
    is JSON; an unrolled generate loop shrinks ~25x); ``torch.export.load``
    reads either form."""
    out = io.BytesIO()
    with zipfile.ZipFile(io.BytesIO(archive)) as src, \
            zipfile.ZipFile(out, "w", zipfile.ZIP_DEFLATED) as dst:
        for info in src.infolist():
            dst.writestr(info, src.read(info.filename), compress_type=zipfile.ZIP_DEFLATED)
    return out.getvalue()


def export_serving_forward(model: nn.Module, state: Dict[str, torch.Tensor],
                           sample: torch.Tensor) -> bytes:
    """Serialize the serve-mode ``model``'s forward (in eval mode) as a
    ``torch.export`` program: ``load_exported(blob)(state, x)`` with ``x``
    of ``sample``'s shape and dtype.  ``state`` (``model.state_dict()``)
    fixes the calling convention; ``sample`` the input."""
    return _export(model, lambda m, x: m(x), state, sample)


def export_generate(model: nn.Module, state: Dict[str, torch.Tensor], prompt_len: int,
                    n_new: int, *, batch_size: int = 1,
                    cache_dtype=torch.float32) -> bytes:
    """Serialize the greedy generate loop of the serve-mode LM ``model``
    (prefill plus ``n_new - 1`` decode steps over a KV cache of
    ``cache_dtype``, the int8 and ``"int4"`` layouts included) as one
    program: ``load_exported(blob)(state, prompts)`` with prompts
    ``(batch_size, prompt_len)`` int32 -> ``(batch_size, n_new)`` int32."""
    make_generate(model, prompt_len, n_new)  # checks prompt_len + n_new against max_len

    def run(m, prompts):  # make_generate's loop over the copy that takes the state
        return make_generate(m, prompt_len, n_new, cache_dtype=cache_dtype)(prompts)

    prompts = torch.zeros((batch_size, prompt_len), dtype=torch.int32, device=model.device)
    return _export(model, run, state, prompts)


def load_exported(blob: bytes) -> Callable:
    """Deserialize an exported program into a callable ``(state, x)``; each
    call checks the recorded calling convention (``state`` is taken as a
    plain dict: a ``state_dict()``'s OrderedDict has the same entries)."""
    program = torch.export.load(io.BytesIO(blob)).module()

    def call(state: Dict[str, torch.Tensor], x):
        return program(dict(state), x)

    return call


def save_exported_file(path: str, blob: bytes) -> str:
    with open(path, "wb") as f:
        f.write(blob)
    return path


def load_exported_file(path: str) -> Callable:
    with open(path, "rb") as f:
        return load_exported(f.read())

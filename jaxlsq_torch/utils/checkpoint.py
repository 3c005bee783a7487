"""Checkpoint and resume (port of ``jaxlsq/utils/checkpoint.py``).

The JAX package saves one state pytree and restores it into the structure of
a target tree.  Here the state is a dict of named objects that have
``state_dict()``/``load_state_dict()`` (the model, the optimizer, ...), and a
restore writes into them IN PLACE:

* a module through its own ``load_state_dict``, which copies into every
  existing parameter and buffer (the quantizers' buffers too, whose bumped
  version counters make the eager regime refill its host mirror);
* an optimizer by copying each saved state tensor, and each hyperparameter
  held as a tensor (the device lr of ``make_train_step(jit=True)``), into
  the tensor already there; ``Optimizer.load_state_dict`` would put new
  tensors in their place, and a CUDA graph captured before the restore
  would go on stepping the old ones.  State a fresh optimizer has not made
  yet is placed as torch's ``load_state_dict`` places it.  A
  ``QATOptimizer`` restores each of its inner optimizers so.

The directory protocol is the JAX package's: one ``step_%010d`` directory a
step, each object's state dict in ``<name>.pt``, and a ``_COMPLETE`` marker
written last; :func:`latest_step` takes the largest marked step and ignores
anything else (``step_tmp``, a write that did not finish).  Files are read
with ``torch.load(weights_only=True)``, a module's onto its own device, the
rest onto the CPU before they are copied or placed.  A restore whose keys
differ from the target's raises before anything is written, naming up to 8
keys on each side.  There is no orbax backend: a directory the JAX package
wrote through orbax is not a checkpoint here.
"""

from __future__ import annotations

import os
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch import nn

from .._device import device_of
from ..parallel.optim import QATOptimizer

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step", "restore_or_init"]

_MARKER = "_COMPLETE"


def _step_dir(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"step_{step:010d}")


def latest_step(ckpt_dir: str) -> Optional[int]:
    """The largest completed checkpoint step in ``ckpt_dir``, or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(name[5:]) for name in os.listdir(ckpt_dir)
             if name.startswith("step_") and name[5:].isdigit()
             and os.path.exists(os.path.join(ckpt_dir, name, _MARKER))]
    return max(steps) if steps else None


def save_checkpoint(ckpt_dir: str, state: Dict[str, Any], step: int) -> str:
    """Write each object's ``state_dict()`` for ``step``; returns the step's
    directory.  The step counts as written once its marker is there."""
    for name in state:
        if not name or "/" in name or name.startswith("."):
            raise ValueError(f"checkpoint object names are plain file names, got {name!r}")
    path = _step_dir(ckpt_dir, step)
    os.makedirs(path, exist_ok=True)
    marker = os.path.join(path, _MARKER)
    if os.path.exists(marker):  # rewriting a step: not complete until done
        os.remove(marker)
    for name, obj in state.items():
        torch.save(obj.state_dict(), os.path.join(path, f"{name}.pt"))
    with open(marker, "w") as f:
        f.write("ok")
    return path


def _paths(tree, prefix: str) -> List[str]:
    """The leaf paths of a nested state dict ('/'-joined keys)."""
    if isinstance(tree, dict):
        return [p for k, v in tree.items() for p in _paths(v, f"{prefix}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [p for i, v in enumerate(tree) for p in _paths(v, f"{prefix}/{i}")]
    return [prefix]


def _is_optimizer_dict(tree) -> bool:
    return isinstance(tree, dict) and "state" in tree and "param_groups" in tree


def _as_restored(target, saved):
    """``target`` (an object's state dict) with every optimizer parameter
    state it has not made yet taken from ``saved``: a fresh optimizer has no
    state, and that is no mismatch."""
    if _is_optimizer_dict(target) and _is_optimizer_dict(saved):
        return {**target, "state": {**{i: v for i, v in saved["state"].items()
                                       if i not in target["state"]},
                                    **target["state"]}}
    if isinstance(target, dict) and isinstance(saved, dict):
        return {k: _as_restored(v, saved.get(k)) for k, v in target.items()}
    return target


def _put(container, key, value, fresh: Callable = None) -> None:
    """``container[key] = value``, into the tensor already there when there
    is one; a number stays a number."""
    cur = container.get(key)
    if torch.is_tensor(cur):
        if not torch.is_tensor(value):
            cur.fill_(value)
        elif cur.shape != value.shape:
            raise ValueError(f"optimizer state {key!r}: shape {tuple(value.shape)} != "
                             f"{tuple(cur.shape)}")
        else:
            cur.copy_(value)
    elif torch.is_tensor(value):
        if cur is not None and value.dim() == 0:
            container[key] = value.item()
        else:
            container[key] = value if fresh is None else fresh(value)
    else:
        container[key] = value


@torch.no_grad()
def _load_optimizer(opt: torch.optim.Optimizer, sd: Dict) -> None:
    if isinstance(opt, QATOptimizer):
        for key, inner in (("weights", opt.weights), ("qparams", opt.qparams)):
            if inner is not None:
                _load_optimizer(inner, sd[key])
        return
    saved_groups = sd["param_groups"]
    for group, saved in zip(opt.param_groups, saved_groups):
        for k, v in saved.items():
            if k != "params":
                _put(group, k, v)
    ids = [i for g in saved_groups for i in g["params"]]
    params = [p for g in opt.param_groups for p in g["params"]]
    for i, p in zip(ids, params):
        for k, v in sd["state"].get(i, {}).items():
            _put(opt.state[p], k, v, lambda t, p=p, i=i, k=k: (
                torch.optim.Optimizer._process_value_according_to_param_policy(
                    p, t, i, saved_groups, k)))


def restore_checkpoint(ckpt_dir: str, state: Dict[str, Any],
                       step: Optional[int] = None) -> Dict[str, Any]:
    """Restore the checkpoint of ``step`` (default: the latest) into the
    objects of ``state`` in place; returns ``state``."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    path = _step_dir(ckpt_dir, step)
    if not os.path.exists(os.path.join(path, _MARKER)):
        raise FileNotFoundError(f"{path} is not a complete checkpoint")
    names = sorted(f[:-3] for f in os.listdir(path) if f.endswith(".pt"))
    saved, got = set(), set()
    loaded = {}
    for name in names:
        obj = state.get(name)
        loc = device_of(obj) if isinstance(obj, nn.Module) else "cpu"
        loaded[name] = torch.load(os.path.join(path, f"{name}.pt"), map_location=loc,
                                  weights_only=True)
        saved.update(_paths(loaded[name], name))
    for name, obj in state.items():
        got.update(_paths(_as_restored(obj.state_dict(), loaded.get(name)), name))
    if saved != got:
        raise ValueError(
            "checkpoint keys do not match the target's:\n"
            f"  only in checkpoint: {sorted(saved - got)[:8]}\n"
            f"  only in target:     {sorted(got - saved)[:8]}")
    for name, obj in state.items():
        if isinstance(obj, torch.optim.Optimizer):
            _load_optimizer(obj, loaded[name])
        else:
            obj.load_state_dict(loaded[name])
    return state


def restore_or_init(ckpt_dir: str, init_fn: Callable[[], Dict[str, Any]]
                    ) -> Tuple[Dict[str, Any], int]:
    """Restart from the latest checkpoint if there is one: ``init_fn()``
    builds the state (the restore target) in both cases; returns ``(state,
    step)``, step -1 on a fresh start."""
    state = init_fn()
    step = latest_step(ckpt_dir)
    if step is None:
        return state, -1
    return restore_checkpoint(ckpt_dir, state, step), step

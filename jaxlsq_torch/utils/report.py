"""Model-wide quantizer state reports (port of ``jaxlsq/utils/report.py``).

:func:`quantizer_report` gives one row per :class:`FakeQuantize` of a model:
its path (the JAX package's '/'-joined quantizer path, e.g.
``dense_0/act_fq``: the layer path each layer resolves its qconfig with,
plus the quantizer's name), channels, the qparams' ranges, the three mode
flags and the init window's progress.  The values of every quantizer on a
device are read in one batched device-to-host copy.
:func:`serving_size_report` counts the bytes of a serve-mode model's packed
weights against everything else.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional

import torch
from torch import nn

from ..models.layers import FakeQuantize, _PackedBuffers

__all__ = ["quantizer_report", "format_report", "serving_size_report"]

_FLAGS = ("fake_quant_enabled", "observer_enabled", "learning_enabled")


def quantizer_report(model: nn.Module) -> List[Dict[str, Any]]:
    """One row per quantizer of ``model``: ``path``, ``channels``,
    ``scale_min/max``, ``shift_min/max``, the three flags, ``current_batch``,
    ``n_batches`` and ``in_init_window``, in module order."""
    fqs = [(name, m) for name, m in model.named_modules() if isinstance(m, FakeQuantize)]
    by_device: Dict[torch.device, list] = {}
    for i, (_, m) in enumerate(fqs):
        by_device.setdefault(m.scale.device, []).append(i)
    values: List[Optional[list]] = [None] * len(fqs)
    with torch.no_grad():
        for idx in by_device.values():
            rows = []
            for i in idx:
                m = fqs[i][1]
                rows.append(torch.stack(
                    [m.scale.min(), m.scale.max(), m.shift.min(), m.shift.max()]
                    ).to(torch.float64))
                rows.append(torch.stack([getattr(m, f).to(torch.float64).reshape(())
                                         for f in _FLAGS + ("current_batch", "n_batches")]))
            flat = torch.cat(rows).tolist()  # one copy a device
            for k, i in enumerate(idx):
                values[i] = flat[9 * k:9 * (k + 1)]
    out = []
    for (name, m), v in zip(fqs, values):
        row: Dict[str, Any] = {
            "path": "/".join(name.split(".")),
            "channels": int(m.scale.shape[0]),
            "scale_min": v[0], "scale_max": v[1], "shift_min": v[2], "shift_max": v[3],
        }
        for f, x in zip(_FLAGS, v[4:7]):
            row[f] = bool(x)
        row["current_batch"] = int(v[7])
        row["n_batches"] = int(v[8])
        row["in_init_window"] = (row["n_batches"] >= 0
                                 and row["current_batch"] <= row["n_batches"])
        out.append(row)
    return out


def format_report(rows: List[Dict[str, Any]], max_rows: Optional[int] = None) -> str:
    """Human-readable table of :func:`quantizer_report` rows."""
    out = []
    for row in rows[:max_rows]:
        flags = "".join(ch if row.get(name, False) else "-"
                        for ch, name in (("F", "fake_quant_enabled"),
                                         ("O", "observer_enabled"),
                                         ("L", "learning_enabled")))
        init = ""
        if row.get("in_init_window"):
            init = f"  init {row['current_batch']}/{row['n_batches']}"
        out.append(
            f"{row['path']:<48s} [{flags}] C={row['channels']:<5d} "
            f"scale[{row['scale_min']:.3e},{row['scale_max']:.3e}] "
            f"shift[{row['shift_min']:.3e},{row['shift_max']:.3e}]{init}")
    if max_rows is not None and len(rows) > max_rows:
        out.append(f"... {len(rows) - max_rows} more")
    return "\n".join(out)


def serving_size_report(model: nn.Module) -> Dict[str, Any]:
    """Byte accounting of a serve-mode model: its packed integer weights
    (data, f32 scales, int32 zero points) against every other parameter and
    buffer, the f32-equivalent size and the compression ratio."""
    packed_bytes = packed_f32_equiv = n_packed = 0
    packed_ids = set()
    for m in model.modules():
        if isinstance(m, _PackedBuffers):
            n_packed += 1
            packed_bytes += (m.data.numel() * m.data.element_size()
                             + m.scale.numel() * 4 + m.zero_point.numel() * 4)
            packed_f32_equiv += 4 * math.prod(m.orig_shape)
            packed_ids.update(id(t) for t in (m.data, m.scale, m.zero_point))
    other_bytes = sum(t.numel() * t.element_size()
                      for t in model.state_dict(keep_vars=True).values()
                      if id(t) not in packed_ids)
    total = packed_bytes + other_bytes
    f32_total = packed_f32_equiv + other_bytes
    return {
        "packed_weights": n_packed,
        "packed_bytes": packed_bytes,
        "other_bytes": other_bytes,
        "total_bytes": total,
        "f32_equivalent_bytes": f32_total,
        "compression": round(f32_total / max(total, 1), 3),
    }

"""Causal flash attention for the training path (port of the upstream Pallas
kernel that ``jaxlsq/models/zoo.py:_flash_train_attention`` calls,
``jax/experimental/pallas/ops/tpu/flash_attention.py``: forward kernel :331,
launched :758; dK/dV kernel :796, launched :1121; dQ kernel :1146, launched
:1456).

``flash_attention(q, k, v, sm_scale)`` takes q/k/v (B, H, t, hd) f32 with as
many kv heads as query heads (the caller repeats them for GQA) and returns
``softmax(q kᵀ · sm_scale + causal mask) v`` without ever holding the
(t, t) scores: a ``torch.autograd.Function`` whose forward saves the output
and the per-row log-sum-exp (B, H, t) and whose backward computes
``D = rowsum(dO ∘ O)`` as one plain tensor op (as upstream computes ``di``
outside its kernels) and then dQ, dK and dV in one launch.

Each pass is a function here that takes its kernel's plain version for CPU
tensors and launches its kernel (``csrc/flash_attention.cu``: 3xTF32
products on the tensor cores) for CUDA tensors or raises; the plain versions
are written from the formulas (scores, mask, exponentials), not through
autograd, so each kernel has its own yardstick:

* :func:`flash_fwd` -> (out, lse) — ``flash_fwd`` kernel;
* :func:`flash_bwd` -> (dq, dk, dv) — ``flash_bwd`` kernel, one launch with
  a dK/dV role and a dQ role; its plain version composes
  :func:`flash_bwd_dkv_plain` and :func:`flash_bwd_dq_plain`.

Any t works (the kernels mask the ragged tail tile).  The kernels take
head_dim 32, 64 or 128 and raise ``ValueError`` on any other; CPU tensors
take the plain versions at any head_dim.  ``LAUNCHES`` counts each kernel's
launches.
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from .. import _build

__all__ = ["flash_attention", "flash_fwd", "flash_bwd", "flash_fwd_plain",
           "flash_bwd_plain", "flash_bwd_dkv_plain", "flash_bwd_dq_plain",
           "LAUNCHES", "HEAD_DIMS"]

LAUNCHES = {"flash_fwd": 0, "flash_bwd": 0}
HEAD_DIMS = (32, 64, 128)


def _causal(t: int, device) -> torch.Tensor:
    return torch.ones((t, t), dtype=torch.bool, device=device).tril()


def _probs(q, k, lse, sm_scale):
    """P = exp(S · sm − lse) on the causal triangle, 0 above it."""
    return torch.exp(_masked_scores(q, k, sm_scale) - lse[..., None])


def _masked_scores(q, k, sm_scale):
    """S · sm on the causal triangle, −inf above it."""
    s = torch.matmul(q, k.transpose(-1, -2)) * sm_scale
    return torch.where(_causal(q.shape[2], q.device), s, torch.full_like(s, -torch.inf))


def flash_fwd_plain(q, k, v, sm_scale: float):
    """(out, lse): causal softmax attention and each row's log-sum-exp."""
    s = _masked_scores(q, k, sm_scale)
    lse = torch.logsumexp(s, dim=-1)
    return torch.matmul(torch.exp(s - lse[..., None]), v), lse


def flash_bwd_dkv_plain(q, k, v, do, lse, d, sm_scale: float):
    """(dk, dv): dV = Pᵀ dO, dS = P ∘ (dO Vᵀ − D), dK = sm · dSᵀ Q."""
    p = _probs(q, k, lse, sm_scale)
    ds = p * (torch.matmul(do, v.transpose(-1, -2)) - d[..., None])
    return (torch.matmul(ds.transpose(-1, -2), q) * sm_scale,
            torch.matmul(p.transpose(-1, -2), do))


def flash_bwd_dq_plain(q, k, v, do, lse, d, sm_scale: float):
    """dQ = sm · dS K with dS = P ∘ (dO Vᵀ − D)."""
    p = _probs(q, k, lse, sm_scale)
    ds = p * (torch.matmul(do, v.transpose(-1, -2)) - d[..., None])
    return torch.matmul(ds, k) * sm_scale


def flash_bwd_plain(q, k, v, do, lse, d, sm_scale: float):
    """(dq, dk, dv): :func:`flash_bwd_dq_plain` and :func:`flash_bwd_dkv_plain`."""
    dk, dv = flash_bwd_dkv_plain(q, k, v, do, lse, d, sm_scale)
    return flash_bwd_dq_plain(q, k, v, do, lse, d, sm_scale), dk, dv


def _check(what: str, q: torch.Tensor, *others: torch.Tensor) -> None:
    """What the kernels take: CUDA f32 contiguous (B, H, t, hd) tensors on
    one device, hd in ``HEAD_DIMS``; (B, H, t) row vectors."""
    if q.dim() != 4:
        raise ValueError(f"{what}: q must be (B, H, t, hd), got {tuple(q.shape)}")
    b, h, t, hd = q.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"{what}: head_dim {hd} not supported by the kernel "
                         f"(one of {HEAD_DIMS})")
    for x in (q,) + others:
        if x.dtype != torch.float32:
            raise ValueError(f"{what}: the kernel takes f32, got {x.dtype}")
        if x.device != q.device:
            raise ValueError(f"{what}: every tensor must be on {q.device}")
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{what}: tensors must be contiguous and 16-byte aligned")
        if tuple(x.shape) not in ((b, h, t, hd), (b, h, t)):
            raise ValueError(f"{what}: shape {tuple(x.shape)} does not match q's "
                             f"{(b, h, t, hd)}")


def _dispatch(what: str, q: torch.Tensor) -> bool:
    """True to launch the kernel (CUDA), False for the plain version (CPU)."""
    if q.device.type == "cpu":
        return False
    if q.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {q.device}")
    return True


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def flash_fwd(q, k, v, sm_scale: float):
    """(out (B, H, t, hd), lse (B, H, t)) of causal attention."""
    if not _dispatch("flash_fwd", q):
        return flash_fwd_plain(q, k, v, sm_scale)
    _check("flash_fwd", q, k, v)
    b, h, t, hd = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    err = _build.load_library().jlt_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
        b * h, t, hd, float(sm_scale), _stream(q))
    LAUNCHES["flash_fwd"] += 1
    _build.check(err, "flash_fwd")
    return out, lse


def flash_bwd(q, k, v, do, lse, d, sm_scale: float):
    """(dq, dk, dv) of causal attention, given the forward's lse and
    D = rowsum(dO ∘ O)."""
    if not _dispatch("flash_bwd", q):
        return flash_bwd_plain(q, k, v, do, lse, d, sm_scale)
    _check("flash_bwd", q, k, v, do, lse, d)
    b, h, t, hd = q.shape
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    err = _build.load_library().jlt_flash_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        d.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b * h, t, hd,
        float(sm_scale), _stream(q))
    LAUNCHES["flash_bwd"] += 1
    _build.check(err, "flash_bwd")
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, sm_scale):
        out, lse = flash_fwd(q, k, v, sm_scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.sm_scale = sm_scale
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        do = do.contiguous()
        d = (do * out).sum(dim=-1)
        dq, dk, dv = flash_bwd(q, k, v, do, lse, d, ctx.sm_scale)
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    sm_scale: float) -> torch.Tensor:
    """Causal attention of q/k/v (B, H, t, hd), differentiable in all three."""
    if not (q.shape == k.shape == v.shape):
        raise ValueError(f"flash_attention: q, k, v shapes {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)} differ (repeat the "
                         "kv heads first)")
    return _FlashAttention.apply(q.contiguous(), k.contiguous(), v.contiguous(),
                                 float(sm_scale))

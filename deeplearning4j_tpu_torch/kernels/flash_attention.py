"""Flash attention forward (K1): the CUDA kernel ``csrc/flash_attention_fwd.cu``
and its plain PyTorch version.

Port of the forward half of ``deeplearning4j_tpu/kernels/flash_attention.py``:
online-softmax attention that keeps the (T, T) score matrix out of device
memory and writes O in the input dtype plus the per-row log-sum-exp in
f32. ``flash_attention`` and ``flash_attention_lse`` take the (B, H, T, D)
layout; ``flash_attention_ntc`` takes the (B, T, H, D) layout the
transformer holds and passes its strides to the kernel, so it copies
nothing.

CPU tensors take :func:`mha_reference` (and its lse twin); CUDA tensors
launch the kernel or raise. The backward kernels (dQ, dK/dV) come with the
training slice: reaching the kernel with inputs that require grad raises.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import _build

NEG_INF = -1e30

_SOURCE = "flash_attention_fwd"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 128)

#: launches of the CUDA kernel since the last reset
LAUNCHES = 0


def reset_launches():
    global LAUNCHES
    LAUNCHES = 0


def flash_attention(q, k, v, scale: Optional[float] = None,
                    causal: bool = False):
    """Fused scaled-dot-product attention. q/k/v: (B, H, T, D) →
    (B, H, T, D) in q's dtype."""
    return _dispatch(q, k, v, scale, causal, layout="bhtd")[0]


def flash_attention_lse(q, k, v, scale: Optional[float] = None,
                        causal: bool = False):
    """Like :func:`flash_attention`, plus the per-row log-sum-exp
    ``lse`` (B, H, T) f32."""
    return _dispatch(q, k, v, scale, causal, layout="bhtd")


def flash_attention_ntc(q, k, v, causal: bool = False,
                        scale: Optional[float] = None):
    """(B, T, H, D)-layout adapter: the transformer's layout, attended
    in place through strides (no transposes, no copies)."""
    return _dispatch(q, k, v, scale, causal, layout="bthd")[0]


def _dispatch(q, k, v, scale, causal, layout):
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    dev = q.device.type
    if dev == "cpu":
        if layout == "bthd":
            q, k, v = (t.transpose(1, 2) for t in (q, k, v))
        out, lse = _reference_lse(q, k, v, scale, causal)
        if layout == "bthd":
            out = out.transpose(1, 2)
        return out, lse
    if dev != "cuda":
        raise ValueError(f"flash attention runs on cpu or cuda tensors, "
                         f"got {q.device}")
    return _flash_cuda(q, k, v, float(scale), causal, layout)


def _flash_cuda(q, k, v, scale, causal, layout):
    global LAUNCHES
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise NotImplementedError(
            "the CUDA flash-attention kernel is forward-only; its backward "
            "(dQ and dK/dV kernels) comes with slice 2 of the port, the "
            "training slice")
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must share a 4-D shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"kernel takes float32 or bfloat16 q/k/v of one "
                         f"dtype, got {q.dtype}/{k.dtype}/{v.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name}'s last dimension must be contiguous")
    if layout == "bthd":
        b, t, h, d = q.shape
        out = torch.empty((b, t, h, d), dtype=q.dtype, device=q.device)
        # view everything as (B, H, T, D) — the kernel reads strides
        q_, k_, v_, o_ = (x.transpose(1, 2) for x in (q, k, v, out))
    else:
        b, h, t, d = q.shape
        out = torch.empty((b, h, t, d), dtype=q.dtype, device=q.device)
        q_, k_, v_, o_ = q, k, v, out
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    lib = _load()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    strides = [s for x in (q_, k_, v_, o_) for s in x.stride()[:3]]
    rc = lib.dl4j_flash_attention_fwd(
        q_.data_ptr(), k_.data_ptr(), v_.data_ptr(), o_.data_ptr(),
        lse.data_ptr(), b, h, t, d, *strides, scale, int(bool(causal)),
        _DTYPES[q.dtype], stream)
    _build.check(rc, "flash_attention_fwd")
    LAUNCHES += 1
    return out, lse


def _load():
    lib = _build.load(_SOURCE)
    fn = lib.dl4j_flash_attention_fwd
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = ([p] * 5 + [i] * 4 + [ll] * 12
                       + [ctypes.c_float, i, i, p])
        fn.restype = i
    return lib


def _scores(q, k, scale, causal):
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if causal:
        t = q.shape[2]
        mask = torch.tril(torch.ones((t, t), dtype=torch.bool,
                                     device=q.device))
        s = torch.where(mask, s, torch.tensor(NEG_INF, device=q.device))
    return s


def _reference_lse(q, k, v, scale, causal):
    s = _scores(q, k, scale, causal)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    out = torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)
    return out, lse


def mha_reference(q, k, v, scale=None, causal=False):
    """The plain version: f32 scores, softmax, weighted sum; (B, H, T, D)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    p = torch.softmax(_scores(q, k, scale, causal), dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


def mha_reference_lse(q, k, v, scale=None, causal=False):
    """The plain version of :func:`flash_attention_lse`."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    return _reference_lse(q, k, v, scale, causal)

"""Flash attention: the forward kernel (K1, ``csrc/flash_attention_fwd.cu``),
the two backward kernels (dQ and dK/dV, ``csrc/flash_attention_bwd.cu``)
and their plain PyTorch versions.

Port of ``deeplearning4j_tpu/kernels/flash_attention.py``: online-softmax
attention that keeps the (T, T) score matrix out of device memory and
writes O in the input dtype plus the per-row log-sum-exp in f32; its
backward rebuilds the probabilities tile by tile from that lse, in the
TPU's two passes (dQ over query tiles, dK/dV over key tiles).
``flash_attention`` and ``flash_attention_lse`` take the (B, H, T, D)
layout; ``flash_attention_ntc`` takes the (B, T, H, D) layout the
transformer holds and passes its strides to the kernels, so it copies
nothing.

All three are one ``torch.autograd.Function`` (:class:`FlashAttention`):
it saves q, k, v, O and lse, computes ``delta = rowsum(dO·O)`` in f32 as
plain torch (minus the lse cotangent for the lse variant) and runs the
backward. CPU tensors take :func:`mha_reference_lse` and
:func:`flash_attention_bwd_reference`; CUDA tensors launch the kernels
or raise — there is no fallback between the two.

On CUDA the dtype and the head dim pick the kernel (:func:`route`).
bfloat16 runs K1, dQ and dK/dV on the tensor cores (bf16 products with
f32 sums, operands copied into shared memory by 16-byte ``cp.async``;
counted in ``LAUNCHES_TC``, ``LAUNCHES_BWD_DQ_TC`` and
``LAUNCHES_BWD_DKV_TC`` besides ``LAUNCHES``, ``LAUNCHES_BWD_DQ`` and
``LAUNCHES_BWD_DKV``); their operands must pass
:func:`check_tc_alignment`, or the call raises. float32 K1, dQ and dK/dV
at D 1-256 run on the tensor cores in split TF32 (``LAUNCHES_TF32X3``,
``LAUNCHES_BWD_DQ_TF32X3``, ``LAUNCHES_BWD_DKV_TF32X3``; padded to 64 or
128 up to D 128, each warp owning 16 whole rows of its outputs, and
counted also in ``LAUNCHES_TF32X3_NARROW``,
``LAUNCHES_BWD_DQ_TF32X3_NARROW`` and ``LAUNCHES_BWD_DKV_TF32X3_NARROW``,
else to 256; no f32 flash kernel runs on the CUDA cores below D 513):
each f32 operand x becomes hi = tf32(x) and
lo = x − hi (read as TF32), and each product hi·hi + hi·lo + lo·hi,
summed in f32; the probabilities and dS split too. One TF32 product keeps
10 mantissa bits, an error near 1e-3, past the f32 tolerance of 1e-4; the
three keep about 21, near f32's own. They take any strides. A launch
that fails raises; it never falls back to another kernel.

Head dims: every D whose tiles fit in the 227 KiB of shared memory a
block may use on the H100, as the reference's Pallas block ``(1, bq, d)``
takes any d (:func:`check_head_dim`; every D up to 1200 for all three
kernels). :func:`route` names the kernel family a (D, dtype) runs in
each of the three kernels: the fast kernels are instantiated on the
padded widths 16, 32, 64 and 128 (bf16 also 256; K1's wide kernels 384
and 512, f32 also 320) and zero-fill the
columns past D inside the kernel — bf16 on the tensor cores when D is a
multiple of 8 (its rows whole 16-byte chunks), up to 256 (dQ and dK/dV
past 128 on two warpgroups that split the columns); f32 K1, dQ and dK/dV
in split TF32 up to 256 (padded to 64, 128 or 256). Past 256, up to 512,
all three run their wide kernels, padded to 384 or 512 (f32 also 320), in
the families ``"wgmma-wide"`` (bf16, a multiple of 8; 16-byte alignment
as above) and ``"tf32x3-wide"`` (f32, any strides), counted in
``LAUNCHES_TC_WIDE``, ``LAUNCHES_BWD_DQ_TC_WIDE``,
``LAUNCHES_BWD_DKV_TC_WIDE`` and the ``_TF32X3_WIDE`` three: bf16 K1 and
dQ on two warpgroups that each hold one half of the output's columns,
bf16 dK/dV on a cluster of two CTAs whose four warpgroups each hold a
quarter of dK's and dV's columns; f32 K1 in split TF32 on pairs of warps
that each hold one half, f32 dQ and dK/dV in split TF32 on a cluster of
two CTAs that each hold one half of every operand's columns. Every other
D runs the head-dim-general CUDA-core kernels (``csrc/flash_general.cuh``;
counted in ``LAUNCHES_GENERAL``, ``LAUNCHES_BWD_DQ_GENERAL`` and
``LAUNCHES_BWD_DKV_GENERAL``), whose tile rows shrink from 64 to 8 as D
grows (:func:`general_rows`): past 512, and for bf16 rows that are not
whole 16-byte chunks.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import _build

NEG_INF = -1e30

_SOURCE = "flash_attention_fwd"
_BWD_SOURCE = "flash_attention_bwd"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: the largest head dim of the fast kernels; each D up to it runs on the
#: kernel instantiated for the smallest of 16, 32, 64, 128 that holds it
#: (the f32 narrow kernels: of 64, 128), the columns past D zero-filled
#: inside the kernel
FAST_MAX_HEAD_DIM = 128
#: the largest bf16 head dim the tensor-core kernels take: past 128 they
#: run instantiated on the padded width 256
TC_MAX_HEAD_DIM = 256
#: the largest f32 head dim of the split-TF32 kernels (padded to 256; at
#: D <= 128 the narrow kernels, to 64 or 128)
TF32X3_MAX_HEAD_DIM = 256
#: the largest head dim of the wide kernels of K1, dQ and dK/dV (padded to
#: 384 or 512, f32 also 320): each output's columns split between two
#: warpgroups or warps (K1, bf16 dQ) or two CTAs of a cluster (dK/dV, f32
#: dQ)
WIDE_MAX_HEAD_DIM = 512
#: shared memory a block may use on the H100 (sm_90): 227 KiB
SMEM_PER_BLOCK = 232448
#: the head-dim-general kernels' f32 tiles, as in csrc/flash_general.cuh
#: (gen_smem_bytes): D-wide tiles, R x R score tiles, per-row vectors
GENERAL_TILES = {"fwd": (4, 1, 3), "dq": (5, 2, 2), "dkv": (6, 2, 2)}
GENERAL_ROWS = (64, 32, 16, 8)

#: launches of each CUDA kernel since the last reset (the plain versions
#: on CPU tensors do not count): K1, the dQ kernel, the dK/dV kernel (any
#: route), and of those each family's (:data:`FAMILY_SUFFIX`): the bf16
#: tensor-core, the f32 split-TF32 and the head-dim-general K1, dQ and
#: dK/dV kernels, and the wide K1, dQ and dK/dV kernels (bf16, f32 split
#: TF32) past D 256; of the split-TF32 K1's, dQ's and dK/dV's, the narrow
#: kernels' (D <= 128, :func:`launch_counter` with ``narrow``)
LAUNCHES = 0
LAUNCHES_BWD_DQ = 0
LAUNCHES_BWD_DKV = 0
LAUNCHES_TC = 0
LAUNCHES_BWD_DQ_TC = 0
LAUNCHES_BWD_DKV_TC = 0
LAUNCHES_TF32X3 = 0
LAUNCHES_TF32X3_NARROW = 0
LAUNCHES_BWD_DQ_TF32X3 = 0
LAUNCHES_BWD_DKV_TF32X3 = 0
LAUNCHES_BWD_DQ_TF32X3_NARROW = 0
LAUNCHES_BWD_DKV_TF32X3_NARROW = 0
LAUNCHES_GENERAL = 0
LAUNCHES_BWD_DQ_GENERAL = 0
LAUNCHES_BWD_DKV_GENERAL = 0
LAUNCHES_TC_WIDE = 0
LAUNCHES_BWD_DQ_TC_WIDE = 0
LAUNCHES_BWD_DKV_TC_WIDE = 0
LAUNCHES_TF32X3_WIDE = 0
LAUNCHES_BWD_DQ_TF32X3_WIDE = 0
LAUNCHES_BWD_DKV_TF32X3_WIDE = 0
#: each kernel family's counter suffix (:func:`launch_counter`)
FAMILY_SUFFIX = {"wgmma": "_TC", "tf32x3": "_TF32X3", "general": "_GENERAL",
                 "wgmma-wide": "_TC_WIDE", "tf32x3-wide": "_TF32X3_WIDE"}
#: the families whose operands :func:`check_tc_alignment` holds
TC_FAMILIES = ("wgmma", "wgmma-wide")
_KERNEL = {"fwd": "", "dq": "_BWD_DQ", "dkv": "_BWD_DKV"}
#: every counter
COUNTERS = tuple(n for n in globals() if n.startswith("LAUNCHES"))

#: bytes of one cp.async copy of the tensor-core kernels
TC_ALIGN = 16


def reset_launches():
    for name in COUNTERS:
        globals()[name] = 0


def launch_counter(kernel: str, family: Optional[str] = None,
                   narrow: bool = False) -> str:
    """The name of the counter of ``kernel`` ("fwd", "dq" or "dkv") on
    kernel ``family`` (a :func:`route` name), or on any family; with
    ``narrow``, of the split-TF32 kernel's narrow form (D <= 128)
    alone."""
    name = f"LAUNCHES{_KERNEL[kernel]}{FAMILY_SUFFIX.get(family, '')}"
    return name + "_NARROW" if narrow else name


def _count(kernel: str, family: str, d: int):
    g = globals()
    g[launch_counter(kernel)] += 1
    g[launch_counter(kernel, family)] += 1
    if family == "tf32x3" and d <= FAST_MAX_HEAD_DIM:
        g[launch_counter(kernel, family, narrow=True)] += 1


def flash_attention(q, k, v, scale: Optional[float] = None,
                    causal: bool = False):
    """Fused scaled-dot-product attention. q/k/v: (B, H, T, D) →
    (B, H, T, D) in q's dtype."""
    return _dispatch(q, k, v, scale, causal, layout="bhtd")[0]


def flash_attention_lse(q, k, v, scale: Optional[float] = None,
                        causal: bool = False):
    """Like :func:`flash_attention`, plus the per-row log-sum-exp
    ``lse`` (B, H, T) f32. Both outputs are differentiable: the lse
    cotangent folds into delta."""
    return _dispatch(q, k, v, scale, causal, layout="bhtd")


def flash_attention_ntc(q, k, v, causal: bool = False,
                        scale: Optional[float] = None):
    """(B, T, H, D)-layout adapter: the transformer's layout, attended
    in place through strides (no transposes, no copies)."""
    return _dispatch(q, k, v, scale, causal, layout="bthd")[0]


def _dispatch(q, k, v, scale, causal, layout):
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash attention runs on cpu or cuda tensors, "
                         f"got {q.device}")
    return FlashAttention.apply(q, k, v, float(scale), bool(causal), layout)


def _bhtd(layout, *ts):
    """(B, H, T, D) views of tensors held in ``layout``."""
    if layout == "bthd":
        return tuple(t.transpose(1, 2) for t in ts)
    return ts


class FlashAttention(torch.autograd.Function):
    """``(q, k, v, scale, causal, layout) → (O, lse)`` with the flash
    backward. ``layout`` is ``"bhtd"`` or ``"bthd"``; lse is (B, H, T)
    f32 in both."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal, layout):
        if q.device.type == "cpu":
            qh, kh, vh = _bhtd(layout, q, k, v)
            out, lse = _reference_lse(qh, kh, vh, scale, causal)
            (out,) = _bhtd(layout, out)
        else:
            out, lse = _flash_cuda(q, k, v, scale, causal, layout)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale, ctx.causal, ctx.layout = scale, causal, layout
        ctx.set_materialize_grads(False)
        return out, lse

    @staticmethod
    def backward(ctx, dout, dlse):
        q, k, v, out, lse = ctx.saved_tensors
        if dout is None:               # only lse was used
            dout = torch.zeros_like(out)
        if dout.stride(-1) != 1 or (dout.dtype == torch.bfloat16
                                    and not tc_aligned(dout)):
            # a fresh copy: contiguous() would keep a misaligned start
            dout = dout.clone(memory_format=torch.contiguous_format)
        delta = (dout.float() * out.float()).sum(-1)
        if ctx.layout == "bthd":
            delta = delta.transpose(1, 2)
        if dlse is not None:
            delta = delta - dlse.float()
        dq, dk, dv = flash_attention_bwd(q, k, v, dout, lse,
                                         delta.contiguous(), ctx.scale,
                                         ctx.causal, ctx.layout)
        return dq, dk, dv, None, None, None


def flash_attention_bwd(q, k, v, dout, lse, delta, scale, causal,
                        layout="bhtd"):
    """The flash backward: ``(dq, dk, dv)`` in q's dtype and layout, from
    the forward's lse and ``delta`` = rowsum(dO·O) (minus dLSE), both
    (B, H, T) f32. CPU tensors take :func:`flash_attention_bwd_reference`;
    CUDA tensors launch the dQ and the dK/dV kernels."""
    if q.device.type == "cpu":
        qh, kh, vh, doh = _bhtd(layout, q, k, v, dout)
        grads = flash_attention_bwd_reference(qh, kh, vh, doh, lse, delta,
                                              scale, causal)
        return _bhtd(layout, *grads)
    if q.device.type != "cuda":
        raise ValueError(f"flash attention runs on cpu or cuda tensors, "
                         f"got {q.device}")
    dq = flash_attention_bwd_dq(q, k, v, dout, lse, delta, scale, causal,
                                layout)
    dk, dv = flash_attention_bwd_dkv(q, k, v, dout, lse, delta, scale,
                                     causal, layout)
    return dq, dk, dv


# ---------------------------------------------------------------- CUDA

def route(d: int, dtype, kernel: str) -> str:
    """The kernel family head dim ``d`` runs in ``dtype`` for ``kernel``
    ("fwd", "dq" or "dkv"; the three agree): ``"wgmma"`` (bf16, a
    multiple of 8 up to ``TC_MAX_HEAD_DIM``), ``"tf32x3"`` (f32, D
    1..256; the narrow kernels up to 128), ``"wgmma-wide"`` (bf16, a
    multiple of 8 in 264..``WIDE_MAX_HEAD_DIM``), ``"tf32x3-wide"`` (f32,
    D 257..512), or ``"general"`` (every other D)."""
    wide = d <= WIDE_MAX_HEAD_DIM
    if dtype == torch.float32:
        if d <= TF32X3_MAX_HEAD_DIM:
            return "tf32x3"
        return "tf32x3-wide" if wide else "general"
    if d % 8 == 0 and d <= TC_MAX_HEAD_DIM:
        return "wgmma"
    if d % 8 == 0 and wide:
        return "wgmma-wide"
    return "general"


def _general_ld(rows: int, d: int) -> int:
    """A general tile's row stride (gen_ld): odd at 32 rows and more,
    else congruent to the lanes that split a dot product, mod 32."""
    ks = 1 if rows >= 32 else 4 if rows == 16 else 16
    return d | 1 if ks == 1 else d + (ks - d % 32) % 32


def general_smem_bytes(kernel: str, rows: int, d: int) -> int:
    """Shared bytes of the general ``kernel`` ("fwd", "dq", "dkv") at
    ``rows`` tile rows and head dim ``d`` (csrc/flash_general.cuh
    gen_smem_bytes)."""
    a, b, c = GENERAL_TILES[kernel]
    return 4 * (a * rows * _general_ld(rows, d) + b * rows * (rows + 1)
                + c * rows)


def general_rows(kernel: str, d: int) -> int:
    """The general ``kernel``'s tile rows at head dim ``d``: the largest
    of 64, 32, 16, 8 whose tiles fit in ``SMEM_PER_BLOCK``; 0 if none."""
    return next((r for r in GENERAL_ROWS
                 if general_smem_bytes(kernel, r, d) <= SMEM_PER_BLOCK), 0)


def check_head_dim(d: int, dtype, kernel: str = "dkv"):
    """Raise ``ValueError`` unless ``kernel`` ("fwd", "dq" or "dkv";
    dK/dV, the largest, by default) takes head dim ``d`` in ``dtype``:
    any D >= 1 whose tiles fit in a block's shared memory (the general
    kernels' 8-row tiles past 1200 for dK/dV)."""
    if d < 1:
        raise ValueError(f"head dim {d} must be at least 1")
    if route(d, dtype, kernel) == "general" and not general_rows(kernel, d):
        need = general_smem_bytes(kernel, GENERAL_ROWS[-1], d)
        raise ValueError(
            f"head dim {d}: the {kernel} kernel's tiles need {need} bytes "
            f"of shared memory at {GENERAL_ROWS[-1]} rows, past the 227 KiB "
            f"({SMEM_PER_BLOCK} bytes) a block may use on the H100")


#: the largest head dim all three kernels take
MAX_HEAD_DIM = max(d for d in range(1, 4096) if general_rows("dkv", d))


def _check_qkv(layout, kernel, q, k, v, dout=None):
    """Shapes, dtypes, devices, strides and head dims ``kernel`` takes;
    returns (b, h, t, d) and the (B, H, T, D) views of q, k, v (and
    dout)."""
    named = [("q", q), ("k", k), ("v", v)]
    if dout is not None:
        named.append(("dout", dout))
    if q.dim() != 4:
        raise ValueError(f"q must be 4-D, got {tuple(q.shape)}")
    if q.dtype not in _DTYPES:
        raise ValueError(f"kernel takes float32 or bfloat16, got {q.dtype}")
    for name, t in named:
        if t.shape != q.shape or t.dtype != q.dtype:
            raise ValueError(f"{name} is {tuple(t.shape)} {t.dtype}, q is "
                             f"{tuple(q.shape)} {q.dtype}: the kernel takes "
                             f"float32 or bfloat16 operands of one shape")
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name}'s last dimension must be contiguous")
    views = _bhtd(layout, *(t for _, t in named))
    b, h, t, d = views[0].shape
    check_head_dim(d, q.dtype, kernel)
    return (b, h, t, d), views


def tc_aligned(x) -> bool:
    """True when the tensor-core kernels can copy ``x``'s rows in
    16-byte chunks: its storage starts on a 16-byte boundary and every
    stride but the last (contiguous) one, of a dimension longer than 1,
    is a whole number of chunks."""
    item = x.element_size()
    return x.data_ptr() % TC_ALIGN == 0 and all(
        n == 1 or (st * item) % TC_ALIGN == 0
        for n, st in zip(x.shape[:-1], x.stride()[:-1]))


def check_tc_alignment(**views):
    """Raise ``ValueError`` naming the first of ``views`` (name → tensor)
    that :func:`tc_aligned` refuses. The bf16 kernels check their
    operands with it before any launch. The transformer's q/k/v (views
    of one (B, T, 3·H·D) buffer at offsets of whole heads) pass."""
    for name, x in views.items():
        if not tc_aligned(x):
            raise ValueError(
                f"{name} (shape {tuple(x.shape)}, strides {x.stride()}, "
                f"address {x.data_ptr():#x}) is not {TC_ALIGN}-byte aligned "
                f"for the bf16 tensor-core kernels: its start and its "
                f"batch, head and time strides must be multiples of "
                f"{TC_ALIGN} bytes")


def _check_rows(name, x, q, bhtd):
    if x.dtype != torch.float32 or tuple(x.shape) != bhtd[:3] \
            or x.device != q.device or not x.is_contiguous():
        raise ValueError(f"{name} must be a contiguous float32 {bhtd[:3]} "
                         f"tensor on {q.device}, got {tuple(x.shape)} "
                         f"{x.dtype} on {x.device}")


def _strides(*views):
    flat = [s for x in views for s in x.stride()[:3]]
    return (ctypes.c_longlong * len(flat))(*flat)


def _flash_cuda(q, k, v, scale, causal, layout):
    (b, h, t, d), (q_, k_, v_) = _check_qkv(layout, "fwd", q, k, v)
    kind = route(d, q.dtype, "fwd")
    if kind in TC_FAMILIES:
        check_tc_alignment(q=q_, k=k_, v=v_)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    (o_,) = _bhtd(layout, out)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    lib = _load()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    strides = [s for x in (q_, k_, v_, o_) for s in x.stride()[:3]]
    rc = lib.dl4j_flash_attention_fwd(
        q_.data_ptr(), k_.data_ptr(), v_.data_ptr(), o_.data_ptr(),
        lse.data_ptr(), b, h, t, d, *strides, scale, int(bool(causal)),
        _DTYPES[q.dtype], stream)
    _build.check(rc, "flash_attention_fwd")
    _count("fwd", kind, d)
    return out, lse


def flash_attention_bwd_dq(q, k, v, dout, lse, delta, scale, causal,
                           layout="bhtd"):
    """dQ of the flash backward in q's layout: the dQ kernel on CUDA
    tensors, the plain backward's dq on CPU tensors."""
    if q.device.type == "cpu":
        return flash_attention_bwd(q, k, v, dout, lse, delta, scale, causal,
                                   layout)[0]
    bhtd, (q_, k_, v_, do_) = _check_qkv(layout, "dq", q, k, v, dout)
    kind = route(bhtd[3], q.dtype, "dq")
    if kind in TC_FAMILIES:
        check_tc_alignment(q=q_, k=k_, v=v_, dout=do_)
    _check_rows("lse", lse, q, bhtd)
    _check_rows("delta", delta, q, bhtd)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    (dq_,) = _bhtd(layout, dq)
    lib = _load_bwd()
    rc = lib.dl4j_flash_attention_bwd_dq(
        q_.data_ptr(), k_.data_ptr(), v_.data_ptr(), do_.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq_.data_ptr(), *bhtd,
        _strides(q_, k_, v_, do_, dq_), float(scale), int(bool(causal)),
        _DTYPES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, "flash_attention_bwd_dq")
    _count("dq", kind, bhtd[3])
    return dq


def flash_attention_bwd_dkv(q, k, v, dout, lse, delta, scale, causal,
                            layout="bhtd"):
    """(dK, dV) of the flash backward in q's layout: the dK/dV kernel on
    CUDA tensors, the plain backward's dk, dv on CPU tensors."""
    if q.device.type == "cpu":
        return flash_attention_bwd(q, k, v, dout, lse, delta, scale, causal,
                                   layout)[1:]
    bhtd, (q_, k_, v_, do_) = _check_qkv(layout, "dkv", q, k, v, dout)
    kind = route(bhtd[3], q.dtype, "dkv")
    if kind in TC_FAMILIES:
        check_tc_alignment(q=q_, k=k_, v=v_, dout=do_)
    _check_rows("lse", lse, q, bhtd)
    _check_rows("delta", delta, q, bhtd)
    dk = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dv = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dk_, dv_ = _bhtd(layout, dk, dv)
    lib = _load_bwd()
    rc = lib.dl4j_flash_attention_bwd_dkv(
        q_.data_ptr(), k_.data_ptr(), v_.data_ptr(), do_.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk_.data_ptr(), dv_.data_ptr(),
        *bhtd, _strides(q_, k_, v_, do_, dk_, dv_), float(scale),
        int(bool(causal)), _DTYPES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, "flash_attention_bwd_dkv")
    _count("dkv", kind, bhtd[3])
    return dk, dv


def _load():
    lib = _build.load(_SOURCE)
    fn = lib.dl4j_flash_attention_fwd
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = ([p] * 5 + [i] * 4 + [ll] * 12
                       + [ctypes.c_float, i, i, p])
        fn.restype = i
    return lib


def _load_bwd():
    lib = _build.load(_BWD_SOURCE)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    ll = ctypes.POINTER(ctypes.c_longlong)
    for name, n_ptr in (("dl4j_flash_attention_bwd_dq", 7),
                        ("dl4j_flash_attention_bwd_dkv", 8)):
        fn = getattr(lib, name)
        if fn.argtypes is None:
            fn.argtypes = [p] * n_ptr + [i] * 4 + [ll, f, i, i, p]
            fn.restype = i
    return lib


# --------------------------------------------------------------- plain

def _causal_mask(t, device):
    return torch.tril(torch.ones((t, t), dtype=torch.bool, device=device))


def _scores(q, k, scale, causal):
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if causal:
        s = torch.where(_causal_mask(q.shape[2], q.device), s,
                        torch.tensor(NEG_INF, device=q.device))
    return s


def _reference_lse(q, k, v, scale, causal):
    s = _scores(q, k, scale, causal)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    out = torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)
    return out, lse


def flash_attention_bwd_reference(q, k, v, dout, lse, delta, scale,
                                  causal):
    """The plain backward, the TPU kernels' formula on (B, H, T, D):
    P = exp(S − lse) with S masked causally to ``NEG_INF``, dP = dO·Vᵀ,
    dS = P·(dP − delta)·scale cast to the input dtype before the dS·K and
    dSᵀ·Q products, dV = Pᵀ·dO with P cast to dO's dtype first; f32
    sums, outputs in q's dtype."""
    s = _scores(q, k, scale, causal)
    p = torch.exp(s - lse[..., None])
    dp = torch.einsum("bhqd,bhkd->bhqk", dout.float(), v.float())
    ds = (p * (dp - delta[..., None]) * scale).to(q.dtype).float()
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, k.float())
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float())
    dv = torch.einsum("bhqk,bhqd->bhkd", p.to(dout.dtype).float(),
                      dout.float())
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


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

"""Fused whole-sequence LSTM (K4): the CUDA kernel of ``csrc/fused_lstm.cu``
and its plain PyTorch version.

Port of ``deeplearning4j_tpu/kernels/fused_lstm.py``. ``xproj`` (B, T, 4H)
is the hoisted input projection x @ W + b, ``rw`` (H, 4H) the recurrent
weights in the same dtype, ``peep`` (3, H) f32 the peepholes [pI, pF, pO]
(zeros for a plain LSTM), ``h0``/``c0`` (B, H) the initial state. The
result is hs (B, T, H) in xproj's dtype, gate order [i, f, o, g].

- :func:`lstm_seq_reference` mirrors the reference's scan step for step,
  including its rounding of the h and c carries to their dtype at each
  step; the kernel keeps the state in f32 across all T steps (as the TPU
  kernel did) and rounds only the output, so in bf16 the two part by a
  few bf16 ulps over a long sequence.
- :func:`fused_lstm_seq` is the autograd Function. Its backward is
  recompute, as in the reference: it replays :func:`lstm_seq_reference`
  under autograd and saves only the inputs (O(B·H) beyond them). The JAX
  package has no backward kernel, so neither has the port.
- :func:`fits_smem` is the counterpart of the reference's ``fits_vmem``:
  whether a block of the kernel fits the card's shared memory and thread
  limits (:func:`lstm_plan`). ``LSTM`` checks it before taking the kernel.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel
or raises — there is no fallback between the two.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _build

_SOURCE = "fused_lstm"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_SMEM = 232448            # bytes of shared memory a block can use (H100)
_MAX_THREADS = 1024
_SMS = 132                    # H100 SXM streaming multiprocessors

#: launches of the CUDA kernel since the last reset (the plain version on
#: CPU tensors does not count)
LAUNCHES = 0


def reset_launches():
    global LAUNCHES
    LAUNCHES = 0


def lstm_plan(b: int, h: int) -> Optional[Tuple[int, int, int, int]]:
    """The kernel's block for batch ``b`` and hidden size ``h``:
    ``(rows, k_slices, threads, smem_bytes)``, or None when no block fits.

    ``rows`` batch rows per block (1, 2 or 4: the fewest that keep the
    blocks within one wave of 132 SMs); ``threads`` = the threads across
    the H groups of 4 adjacent columns (at most 256) × ``k_slices`` slices
    of the K = H reduction, at most 1024; shared memory holds
    k_slices × rows × 4H partial sums, the rounded h and c of the rows and
    the peepholes, all f32."""
    rows = 1
    while rows < 4 and -(-b // rows) > _SMS:
        rows *= 2
    groups = min(256, 32 * -(-h // 32))
    ks = max(1, min(_MAX_THREADS // groups, h // 32))
    while True:
        smem = 4 * (ks * rows * 4 * h + 2 * rows * h + 3 * h)
        if smem <= _MAX_SMEM:
            return rows, ks, groups * ks, smem
        if ks > 1:
            ks //= 2
        elif rows > 1:
            rows //= 2
        else:
            return None


def fits_smem(b: int, h: int) -> bool:
    """Whether the kernel takes batch ``b`` at hidden size ``h`` (any T,
    f32 or bf16). ``LSTM`` takes the scan when this is False."""
    return lstm_plan(b, h) is not None


# ------------------------------------------------------------ plain version

def lstm_seq_reference(xproj, rw, peep, h0, c0):
    """The reference's ``lstm_seq_reference`` (a scan over t): gate math in
    f32 whatever the carry dtype, the carries rounded back to it at each
    step. Also the recompute target of the backward."""
    h = h0.shape[-1]
    hp, cp = h0, c0
    dt = torch.promote_types(torch.promote_types(hp.dtype, rw.dtype),
                             xproj.dtype)
    rwd = rw.to(dt)
    peep = peep.float()
    outs = []
    for t in range(xproj.shape[1]):
        z = (xproj[:, t].to(dt) + hp.to(dt) @ rwd).float()
        c32 = cp.float()
        zi = z[:, :h] + c32 * peep[0]
        zf = z[:, h:2 * h] + c32 * peep[1]
        zo, zg = z[:, 2 * h:3 * h], z[:, 3 * h:]
        c_new = torch.sigmoid(zf) * c32 + torch.sigmoid(zi) * torch.tanh(zg)
        h_new = torch.sigmoid(zo + c_new * peep[2]) * torch.tanh(c_new)
        hp, cp = h_new.to(h0.dtype), c_new.to(c0.dtype)
        outs.append(hp)
    return torch.stack(outs, dim=1)


# --------------------------------------------------------------- autograd

def fused_lstm_seq(xproj, rw, peep, h0, c0):
    """Whole-sequence LSTM: (B, T, 4H) projections → (B, T, H) hiddens."""
    return _FusedLstmSeq.apply(xproj, rw, peep, h0, c0)


class _FusedLstmSeq(torch.autograd.Function):

    @staticmethod
    def forward(ctx, xproj, rw, peep, h0, c0):
        ctx.save_for_backward(xproj, rw, peep, h0, c0)
        if xproj.device.type == "cpu":
            return lstm_seq_reference(xproj, rw, peep, h0, c0)
        return lstm_seq(xproj, rw, peep, h0, c0)

    @staticmethod
    def backward(ctx, g):
        # recompute: replay the plain scan under autograd (no stored gates)
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(need) for t, need in
                   zip(ctx.saved_tensors, ctx.needs_input_grad)]
            hs = lstm_seq_reference(*ins)
            wrt = [t for t in ins if t.requires_grad]
            grads = iter(torch.autograd.grad(hs, wrt, g) if wrt else ())
        return tuple(next(grads) if t.requires_grad else None for t in ins)


# ------------------------------------------------------------ CUDA wrapper

def lstm_seq(xproj, rw, peep, h0, c0):
    """The kernel: hs (B, T, H) in xproj's dtype. ``h0``/``c0`` are read
    as f32 (copied when they are not)."""
    global LAUNCHES
    if xproj.device.type != "cuda":
        raise ValueError(f"lstm_seq needs CUDA tensors, got {xproj.device}")
    if xproj.dim() != 3 or xproj.shape[-1] % 4 or xproj.shape[-1] < 4:
        raise ValueError(f"xproj must be (B, T, 4H), got {tuple(xproj.shape)}")
    b, t, g4 = xproj.shape
    h = g4 // 4
    if xproj.dtype not in _DTYPES:
        raise ValueError(f"the kernel takes float32 or bfloat16, got "
                         f"{xproj.dtype}")
    for name, v, shape, dtype in (("xproj", xproj, (b, t, g4), xproj.dtype),
                                  ("rw", rw, (h, g4), xproj.dtype),
                                  ("peep", peep, (3, h), torch.float32)):
        if tuple(v.shape) != shape or v.dtype != dtype \
                or v.device != xproj.device or not v.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {shape} {dtype} "
                             f"tensor on {xproj.device}, got "
                             f"{tuple(v.shape)} {v.dtype} on {v.device}")
        if v.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    for name, v in (("h0", h0), ("c0", c0)):
        if tuple(v.shape) != (b, h) or v.device != xproj.device:
            raise ValueError(f"{name} must be ({b}, {h}) on {xproj.device}, "
                             f"got {tuple(v.shape)} on {v.device}")
    plan = lstm_plan(b, h)
    if plan is None:
        raise ValueError(f"H {h} does not fit one block's shared memory "
                         "(fits_smem is False)")
    rows, ks, threads, smem = plan
    h0, c0 = (v.float().contiguous() for v in (h0, c0))
    out = torch.empty((b, t, h), dtype=xproj.dtype, device=xproj.device)
    rc = _load().dl4j_lstm_seq(
        xproj.data_ptr(), rw.data_ptr(), peep.data_ptr(), h0.data_ptr(),
        c0.data_ptr(), out.data_ptr(), b, t, h, _DTYPES[xproj.dtype], rows,
        ks, threads, smem, torch.cuda.current_stream(xproj.device).cuda_stream)
    _build.check(rc, "lstm_seq")
    LAUNCHES += 1
    return out


def _load():
    lib = _build.load(_SOURCE)
    if lib.dl4j_lstm_seq.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.dl4j_lstm_seq.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, i,
                                      i, p]
        lib.dl4j_lstm_seq.restype = i
    return lib

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
- Two CUDA routes, chosen by shape (:func:`lstm_route`: B, T, H, the
  dtype and, in f32, how many clusters the card holds at once): the
  cluster route (:func:`lstm_seq_cluster`, planned by
  :func:`lstm_cluster_plan`) keeps rw resident across a thread-block
  cluster, exchanges h through distributed shared memory and runs the
  bf16 product on the tensor cores; the block route
  (:func:`lstm_seq_block`, :func:`lstm_plan`) takes every other shape
  :func:`fits_smem` admits, and f32 sequences too short to pay for the
  cluster route's load of rw. :func:`lstm_seq` dispatches.

A CPU tensor takes the plain version; a CUDA tensor launches a kernel
or raises — there is no fallback between the routes or to the plain
version.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from . import _build

_SOURCE = "fused_lstm"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_SMEM = 232448            # bytes of shared memory a block can use (H100)
_MAX_THREADS = 1024
_SMS = 132                    # H100 SXM streaming multiprocessors

CLUSTER_ROWS = 16             # batch rows a cluster owns (one mma M tile)
_CLUSTER_SIZES = (8, 4, 2, 1)  # CTAs a cluster, largest first (8: portable)
_F32_K_SLICES = (8, 4, 2, 1)   # slices of the f32 reduction, most first
_CLUSTER_THREADS = {torch.bfloat16: 768, torch.float32: 256}

#: f32 only: the fewest steps at which the cluster route beats the block
#: route when the grid's clusters take one wave, two waves; past two the
#: block route. Each CTA loads its rw slice (up to 128 KiB in f32) into
#: shared memory before its first step, while the block route streams rw
#: from L2 at every step. bf16 takes the cluster route at every T: it
#: wins there from T 1.
F32_CLUSTER_MIN_T = (4, 32)

#: launches of the CUDA kernels since the last reset, both routes (the
#: plain version on CPU tensors does not count)
LAUNCHES = 0
#: the same launches by route: "cluster" and "block"
LAUNCHES_BY_ROUTE = {"cluster": 0, "block": 0}


def reset_launches():
    global LAUNCHES
    LAUNCHES = 0
    for route in LAUNCHES_BY_ROUTE:
        LAUNCHES_BY_ROUTE[route] = 0


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


class ClusterPlan(NamedTuple):
    """The cluster route's launch for one shape."""
    cluster: int     # CTAs a cluster (C); CTA k owns units [kH/C, (k+1)H/C)
    rows: int        # batch rows a cluster (R)
    ctas: int        # CTAs of the grid: ceil(B / R) clusters of C
    threads: int     # threads a CTA
    k_slices: int    # slices of the K = H reduction
    smem: int        # bytes of dynamic shared memory a CTA


def cluster_smem(h: int, c: int, dtype, k_slices: int = 1) -> int:
    """Bytes of shared memory a CTA of the cluster route uses (the
    ``mma_smem`` and ``ffma_smem`` of ``csrc/fused_lstm.cu``). bf16: the rw
    slice (Kp, 4U + 8) and two h buffers (16, Kp + 8), Kp = H rounded up
    to 16, and each warp's partial sums of the other warp's rows
    (U/8, 2, 8, 32) f32; f32: the rw slice (H, 4U), two h buffers (H, 16),
    the k-slice partial sums (k_slices, 16, 4U) and c (16, U)."""
    u = h // c
    if dtype == torch.bfloat16:
        kp = -(-h // 16) * 16
        return 2 * (kp * (4 * u + 8) + 2 * CLUSTER_ROWS * (kp + 8)) + 256 * u
    return 4 * (h * 4 * u + 2 * h * CLUSTER_ROWS
                + k_slices * CLUSTER_ROWS * 4 * u + CLUSTER_ROWS * u)


def lstm_cluster_plan(b: int, h: int, dtype) -> Optional[ClusterPlan]:
    """The cluster route's launch for batch ``b``, hidden size ``h`` and
    ``dtype``, or None where the route does not apply: the plan of
    :func:`_cluster_plan_at` at the first cluster size of 8, 4, 2, 1 that
    has one. A larger C gives each CTA a smaller slice of rw, so this is
    the largest C with H / C a multiple of 8 (bf16 H ≤ 384, f32 H ≤ 256
    at C 8)."""
    if dtype not in _DTYPES or b < 1:
        return None
    return next((p for p in (_cluster_plan_at(b, h, dtype, c)
                             for c in _CLUSTER_SIZES) if p is not None), None)


def _cluster_plan_at(b: int, h: int, dtype, c: int) -> Optional[ClusterPlan]:
    """The cluster route's launch at cluster size ``c``, or None where H / C
    is not a multiple of 8 (the width of an mma n-tile: a warp owns 8
    units in bf16) or the rw slice, the two h buffers and the scratch pass
    232,448 bytes a CTA. The K = H reduction is split in ``k_slices``:
    bf16 between the two warps of each group of 8 units (so H needs two
    16-deep k steps, and 8U threads stay within 768); f32 the most of 8,
    4, 2, 1 that keeps 2U threads a slice within 256, at least 8 k a
    slice and the shared memory."""
    if dtype not in _DTYPES or b < 1 or h % c or h // c % 8:
        return None
    u = h // c
    if dtype == torch.bfloat16:
        if -(-h // 16) < 2:
            return None
        ks, threads = 2, 8 * u
    else:
        ks = next((k for k in _F32_K_SLICES if 2 * u * k <= 256
                   and h % k == 0 and h // k >= 8
                   and cluster_smem(h, c, dtype, k) <= _MAX_SMEM), None)
        if ks is None:
            return None
        threads = 2 * u * ks
    smem = cluster_smem(h, c, dtype, ks)
    if smem > _MAX_SMEM or threads > _CLUSTER_THREADS[dtype]:
        return None
    return ClusterPlan(c, CLUSTER_ROWS, -(-b // CLUSTER_ROWS) * c, threads,
                       ks, smem)


def lstm_route(b: int, t: int, h: int, dtype,
               resident: Optional[int] = None) -> Optional[str]:
    """The route :func:`lstm_seq` takes at batch ``b``, ``t`` steps,
    hidden size ``h`` and ``dtype``: "cluster" where
    :func:`lstm_cluster_plan` applies and, in f32, ``t`` reaches
    :data:`F32_CLUSTER_MIN_T` for the waves the grid's clusters take, else
    "block" where :func:`lstm_plan` does, else None.

    ``resident`` is how many of the plan's clusters the card holds at once
    (:func:`cluster_max_active`); only f32 needs it, and it is read from
    the current card when not given."""
    plan = lstm_cluster_plan(b, h, dtype)
    if plan is not None and dtype == torch.float32:
        if resident is None:
            resident = _resident_clusters(b, h, dtype)
        if resident < 1:
            raise RuntimeError(f"the card holds no cluster of the f32 plan "
                               f"{plan}")
        waves = -(-(plan.ctas // plan.cluster) // resident)
        if waves > len(F32_CLUSTER_MIN_T) or t < F32_CLUSTER_MIN_T[waves - 1]:
            plan = None
    if plan is not None:
        return "cluster"
    return "block" if lstm_plan(b, h) is not None else None


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


# ----------------------------------------------------------- CUDA wrappers

def lstm_seq(xproj, rw, peep, h0, c0):
    """The kernel: hs (B, T, H) in xproj's dtype, on the route
    :func:`lstm_route` picks by shape. ``h0``/``c0`` are read as f32 at a
    16-byte aligned address (copied when they are not)."""
    b, t, h = _check(xproj, rw, peep, h0, c0)
    if lstm_route(b, t, h, xproj.dtype) == "cluster":
        return lstm_seq_cluster(xproj, rw, peep, h0, c0)
    return lstm_seq_block(xproj, rw, peep, h0, c0)


def lstm_seq_cluster(xproj, rw, peep, h0, c0):
    """The cluster route (``lstm_seq_cluster_mma_kernel`` in bf16,
    ``lstm_seq_cluster_ffma_kernel`` in f32); raises where
    :func:`lstm_cluster_plan` does not apply or the card refuses the
    launch."""
    b, t, h = _check(xproj, rw, peep, h0, c0)
    plan = lstm_cluster_plan(b, h, xproj.dtype)
    if plan is None:
        raise ValueError(f"the cluster route does not take H {h} in "
                         f"{xproj.dtype} (lstm_cluster_plan is None)")
    return _launch("cluster", "dl4j_lstm_seq_cluster", xproj, rw, peep, h0,
                   c0, plan.cluster, plan.k_slices, plan.threads, plan.smem)


def lstm_seq_block(xproj, rw, peep, h0, c0):
    """The block route (``lstm_seq_kernel``); raises where
    :func:`lstm_plan` does not apply."""
    b, t, h = _check(xproj, rw, peep, h0, c0)
    plan = lstm_plan(b, h)
    if plan is None:
        raise ValueError(f"H {h} does not fit one block's shared memory "
                         "(fits_smem is False)")
    rows, ks, threads, smem = plan
    return _launch("block", "dl4j_lstm_seq", xproj, rw, peep, h0, c0, rows,
                   ks, threads, smem)


def cluster_max_active(b: int, h: int, dtype) -> int:
    """How many clusters of the cluster route's plan the card keeps
    resident at once (``cudaOccupancyMaxActiveClusters``)."""
    p = lstm_cluster_plan(b, h, dtype)
    if p is None:
        raise ValueError(f"the cluster route does not take H {h} in {dtype}")
    n = _load().dl4j_lstm_cluster_max_active(b, h, _DTYPES[dtype], p.cluster,
                                             p.k_slices, p.threads, p.smem)
    _build.check(-n if n < 0 else 0, "lstm_cluster_max_active")
    return n


_RESIDENT = {}


def _resident_clusters(b: int, h: int, dtype) -> int:
    """:func:`cluster_max_active` of the current card, read once a
    (device, H, dtype)."""
    key = (torch.cuda.current_device(), h, dtype)
    if key not in _RESIDENT:
        _RESIDENT[key] = cluster_max_active(b, h, dtype)
    return _RESIDENT[key]


def _check(xproj, rw, peep, h0, c0):
    """Raise on inputs no route takes; returns (B, T, H)."""
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
    return b, t, h


def _launch(route, fn, xproj, rw, peep, h0, c0, *plan):
    """One launch of ``fn`` of the library with the route's ``plan``
    arguments; counts it."""
    global LAUNCHES
    b, t, g4 = xproj.shape
    h0, c0 = _state(h0), _state(c0)
    out = torch.empty((b, t, g4 // 4), dtype=xproj.dtype, device=xproj.device)
    rc = getattr(_load(), fn)(
        xproj.data_ptr(), rw.data_ptr(), peep.data_ptr(), h0.data_ptr(),
        c0.data_ptr(), out.data_ptr(), b, t, g4 // 4, _DTYPES[xproj.dtype],
        *plan, torch.cuda.current_stream(xproj.device).cuda_stream)
    _build.check(rc, fn)
    LAUNCHES += 1
    LAUNCHES_BY_ROUTE[route] += 1
    return out


def _state(v):
    """``v`` as a contiguous f32 tensor at a 16-byte aligned address (the
    cluster kernels read h0 and c0 in 16-byte loads): ``v`` itself where
    it is one, else a copy."""
    v = v.float().contiguous()
    return v if v.data_ptr() % 16 == 0 else v.clone()


def _load():
    lib = _build.load(_SOURCE)
    if lib.dl4j_lstm_seq.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        for fn in (lib.dl4j_lstm_seq, lib.dl4j_lstm_seq_cluster):
            fn.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, i, i, p]
            fn.restype = i
        lib.dl4j_lstm_cluster_max_active.argtypes = [i] * 7
        lib.dl4j_lstm_cluster_max_active.restype = i
    return lib

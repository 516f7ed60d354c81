"""Fused BatchNorm + activation (K3): the CUDA kernels of
``csrc/fused_bn_act.cu`` and their plain PyTorch versions.

Port of ``deeplearning4j_tpu/kernels/fused_ops.py``. Rows are an (N, C)
view of an NHWC activation (N = B·H·W); per-channel vectors are f32.

- :func:`fused_bn_act` (inference): act(x·scale + shift) in one pass,
  ``scale = gamma/sqrt(var + eps)``, ``shift = beta − mean·scale``
  precomputed by the caller. Its backward recomputes through
  :func:`bn_act_reference` and returns dx in x's dtype.
- :func:`fused_bn_act_train` (training): batch statistics from the
  one-pass shifted moments (Σd, Σd², d = x − center), summed by the stats
  kernel, whose last block also finishes mean, var, inv = rsqrt(var +
  eps), scale and shift (one launch, no C-sized torch ops), then the
  normalize pass. Its backward runs the reduce kernel (Σdz, Σdz·x̂ and
  both over N, one launch) and the dx kernel. ``center``'s gradient is
  zero; the returned mean/var carry none.

A CPU tensor takes the plain version; a CUDA tensor launches the kernels
or raises — there is no fallback between the two, and no "no block fits"
path: the kernels take any contiguous (N, C) with N·C < 2³¹.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from .. import _dist
from . import _build

_SOURCE = "fused_bn_act"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_VEC = {torch.float32: 4, torch.bfloat16: 8}   # elements per 16-byte access
_THREADS = 256
_SMS = 132                                     # H100 SXM
#: reduction blocks a kernel keeps resident on an SM, the grid's depth:
#: the stats kernel 4, the backward reduce 3 (its registers at 256
#: threads; both built with __launch_bounds__(256, 3)), so the grid is one
#: full wave and no SM is left with a lone block of a second wave
_DEPTH = {"stats": 4, "bwd_reduce": 3}
#: rows x tile columns a reduction block streams at least: 32 KiB of bf16
_MIN_BLOCK_ELEMS = 16384
#: channel vectors of a reduction tile: 128-byte row segments of 16-byte
#: vectors, or 32 channels read one element at a time
_TILE_VECS, _TILE_SCALARS = 8, 32
#: the rows of bn_stats's (7, C) and bn_bwd_reduce's (4, C) outputs
STATS_ROWS = ("sum", "sum_sq", "mean", "var", "inv", "scale", "shift")
BWD_REDUCE_ROWS = ("sum_dz", "sum_dz_xhat", "sum_dz_over_n",
                   "sum_dz_xhat_over_n")

#: launches of each CUDA kernel since the last reset (the plain versions
#: on CPU tensors do not count): the normalize+act pass (inference and the
#: training forward), the stats reduction, the backward reduction, the dx
#: pass. Each reduction is one launch, its finish and epilogue included.
LAUNCHES = 0
LAUNCHES_STATS = 0
LAUNCHES_BWD_REDUCE = 0
LAUNCHES_BWD_DX = 0


def reset_launches():
    global LAUNCHES, LAUNCHES_STATS, LAUNCHES_BWD_REDUCE, LAUNCHES_BWD_DX
    LAUNCHES = LAUNCHES_STATS = LAUNCHES_BWD_REDUCE = LAUNCHES_BWD_DX = 0


def _leaky(x):
    return torch.where(x >= 0, x, 0.01 * x)


# the reference's _ACTS (fused_ops.py:50), letter for letter; the index of
# each name is the kernel's activation code
_ACTS = {
    "identity": lambda x: x,
    "relu": F.relu,
    "relu6": lambda x: torch.clamp(x, 0.0, 6.0),
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "swish": F.silu,
    "leakyrelu": _leaky,
    "elu": F.elu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "softplus": lambda x: torch.logaddexp(x, torch.zeros_like(x)),
}
_ACT_CODES = {name: i for i, name in enumerate(_ACTS)}

# the reference's _ACT_GRADS (fused_ops.py:140): act'(z) from the
# PRE-activation z, so the backward never needs the activation output
_ACT_GRADS = {
    "identity": torch.ones_like,
    "relu": lambda z: (z > 0).to(z.dtype),
    "relu6": lambda z: ((z > 0) & (z < 6.0)).to(z.dtype),
    "sigmoid": lambda z: torch.sigmoid(z) * (1 - torch.sigmoid(z)),
    "tanh": lambda z: 1.0 - torch.square(torch.tanh(z)),
    "leakyrelu": lambda z: torch.where(z > 0, 1.0, 0.01).to(z.dtype),
    "softplus": torch.sigmoid,
}


def supported_activation(name) -> bool:
    return isinstance(name, str) and name in _ACTS


def supported_train_activation(name) -> bool:
    return isinstance(name, str) and name in _ACT_GRADS


# ------------------------------------------------------------ plain versions

def bn_act_reference(x2d, scale, shift, activation: str):
    """act(x·scale + shift) over (N, C) rows; f32 for a bf16 x (promotion
    with the f32 vectors), as in the reference."""
    return _ACTS[activation](x2d * scale[None, :] + shift[None, :])


def train_stats_reference(x2d, center, group=None):
    """One-pass shifted batch moments: mean = c + E[x−c],
    var = max(E[(x−c)²] − E[x−c]², 0); over the global batch with a batch
    ``group`` (:func:`global_moments`)."""
    d = x2d.float() - center[None, :]
    s1, s2 = torch.sum(d, dim=0), torch.sum(d * d, dim=0)
    if group is not None:
        return global_moments(s1, s2, center, x2d.shape[0], group)
    return _finish_moments(s1, s2, center, x2d.shape[0])


def _finish_moments(s1, s2, center, n):
    """mean and var from the shifted sums s1 = Σd, s2 = Σd² over n rows
    (C-sized math, shared by the plain and the kernel path)."""
    mean = center + s1 / n
    var = torch.clamp(s2 / n - torch.square(s1 / n), min=0.0)
    return mean, var


def _scale_shift(gamma, beta, mean, inv):
    """The per-channel affine of a batch-stats BN: x·scale + shift."""
    scale = gamma.float() * inv
    return scale, beta.float() - mean * scale


def bn_act_train_reference(x2d, gamma, beta, center, eps, activation,
                           group=None):
    """Batch-stats BN + activation → (y in x's dtype, mean, var); the
    global batch's statistics with a batch ``group``."""
    mean, var = train_stats_reference(x2d, center, group)
    scale, shift = _scale_shift(gamma, beta, mean, torch.rsqrt(var + eps))
    y = _ACTS[activation](x2d.float() * scale + shift)
    return y.to(x2d.dtype), mean, var


def bn_bwd_reference(x2d, g, gamma, beta, mean, inv, activation,
                     group=None):
    """The reference's plain BN backward (fused_ops.py:292-302) →
    (dx in x's dtype, dgamma, dbeta in the params' dtypes). With a batch
    ``group`` the statistics were the global batch's: dx takes the sums
    of every rank, dgamma and dbeta stay this rank's (the gradient
    all-reduce adds them)."""
    n = x2d.shape[0]
    scale, shift = _scale_shift(gamma, beta, mean, inv)
    xf = x2d.float()
    z = xf * scale[None, :] + shift[None, :]
    dz = g.float() * _ACT_GRADS[activation](z)
    xhat = (xf - mean[None, :]) * inv[None, :]
    dbeta = torch.sum(dz, dim=0)
    dgamma = torch.sum(dz * xhat, dim=0)
    sb, sg = dbeta, dgamma
    if group is not None:
        sb, sg = group.all_reduce_(torch.stack([dbeta, dgamma]))
        n = n * group.size
    dx = scale[None, :] * (dz - sb[None, :] / n - xhat * sg[None, :] / n)
    return dx.to(x2d.dtype), dgamma.to(gamma.dtype), dbeta.to(beta.dtype)


def global_moments(s1, s2, center, n, group):
    """mean and var of the global batch from this rank's shifted sums
    over its ``n`` rows (every rank of ``group`` holds as many). The sums
    are summed over the group with a gradient (their cotangents summed
    back), so the plain BN differentiates through it; the fused BN calls
    it inside its forward, where nothing is recorded."""
    s = _dist.all_reduce_sum(torch.stack([s1, s2]), group)
    return _finish_moments(s[0], s[1], center, n * group.size)


# --------------------------------------------------------------- autograd

def fused_bn_act(x2d, scale, shift, activation: str = "identity"):
    """(N, C) rows × per-channel affine + activation, one pass."""
    _check_act(activation, supported_activation)
    return _FusedBnAct.apply(x2d, scale, shift, activation)


def fused_bn_act_train(x2d, gamma, beta, center, eps: float = 1e-5,
                       activation: str = "identity", group=None):
    """(N, C) training BN → ``(y, mean, var)``; mean/var are the batch
    statistics (f32) for the caller's running averages and carry no
    gradient. ``center`` (the running mean) shifts the one-pass moments;
    its gradient is zero.

    With a batch ``group`` (``_dist.Group``; every rank's x has N rows)
    the statistics are the global batch's: the stats kernel's shifted
    sums (rows 0-1) are summed over the group before mean, var, scale
    and shift are finished, and in the backward the reduce kernel's two
    sums are, before the dx kernel; dgamma and dbeta stay this rank's
    sums. The running mean, the shift of every rank's sums, is the same
    on every rank."""
    _check_act(activation, supported_train_activation)
    return _FusedBnActTrain.apply(x2d, gamma, beta, center.detach(),
                                  float(eps), activation, group)


def _check_act(activation, supported):
    if not supported(activation):
        raise ValueError(f"activation {activation!r} has no fused BN kernel")


class _FusedBnAct(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x2d, scale, shift, activation):
        ctx.save_for_backward(x2d, scale, shift)
        ctx.activation = activation
        if x2d.device.type == "cpu":
            return bn_act_reference(x2d, scale, shift, activation) \
                .to(x2d.dtype)
        return bn_act(x2d, scale, shift, activation)

    @staticmethod
    def backward(ctx, g):
        # recompute through the plain version, cast like the primal, so
        # the gradient comes back in x's dtype (bf16 cotangent in, bf16 out)
        x2d, scale, shift = ctx.saved_tensors
        with torch.enable_grad():
            xs = x2d.detach().requires_grad_(ctx.needs_input_grad[0])
            sc = scale.detach().requires_grad_(ctx.needs_input_grad[1])
            sh = shift.detach().requires_grad_(ctx.needs_input_grad[2])
            y = bn_act_reference(xs, sc, sh, ctx.activation).to(x2d.dtype)
            wrt = [t for t in (xs, sc, sh) if t.requires_grad]
            grads = iter(torch.autograd.grad(y, wrt, g) if wrt else ())
        return (next(grads) if xs.requires_grad else None,
                next(grads) if sc.requires_grad else None,
                next(grads) if sh.requires_grad else None, None)


class _FusedBnActTrain(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x2d, gamma, beta, center, eps, activation, group):
        if x2d.device.type == "cpu":
            y, mean, var = bn_act_train_reference(x2d, gamma, beta, center,
                                                  eps, activation, group)
            inv = torch.rsqrt(var + eps)
            scale = shift = None
        else:
            st = bn_stats(x2d, center.float(), gamma.float(), beta.float(),
                          eps)
            if group is None:
                mean, var, inv, scale, shift = st[2:]
            else:
                mean, var = global_moments(st[0], st[1], center.float(),
                                           x2d.shape[0], group)
                inv = torch.rsqrt(var + eps)
                scale, shift = _scale_shift(gamma, beta, mean, inv)
            y = bn_act(x2d, scale, shift, activation)
        ctx.save_for_backward(x2d, gamma, beta, mean, inv, scale, shift)
        ctx.activation, ctx.group = activation, group
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, g, _dmean, _dvar):
        x2d, gamma, beta, mean, inv, scale, shift = ctx.saved_tensors
        act, group = ctx.activation, ctx.group
        if g is None:
            g = torch.zeros_like(x2d)
        if x2d.device.type == "cpu":
            dx, dgamma, dbeta = bn_bwd_reference(x2d, g, gamma, beta, mean,
                                                 inv, act, group)
        else:
            # autograd may hand a strided or expanded cotangent; the
            # kernels read contiguous rows (copied only in that case)
            g = g.contiguous()
            r = bn_bwd_reduce(x2d, g, scale, shift, mean, inv, act)
            corr = r[2:]
            if group is not None:
                corr = group.all_reduce_(r[:2].clone()) \
                    / (x2d.shape[0] * group.size)
            dx = bn_bwd_dx(x2d, g, scale, shift, mean, inv, corr, act)
            # f32 sums: no cast unless the params are in another dtype
            dbeta, dgamma = r[0].to(beta.dtype), r[1].to(gamma.dtype)
        return dx, dgamma, dbeta, None, None, None, None


# ------------------------------------------------------------ CUDA wrappers

def bn_act(x2d, scale, shift, activation):
    """The normalize+act kernel: act(x·scale + shift), x's dtype."""
    global LAUNCHES
    _check_rows("x2d", x2d)
    _check_vecs(x2d, scale=scale, shift=shift)
    y = torch.empty_like(x2d)
    n, c = x2d.shape
    rc = _load().dl4j_bn_act(x2d.data_ptr(), scale.data_ptr(),
                             shift.data_ptr(), y.data_ptr(), n, c,
                             _ACT_CODES[activation], _DTYPES[x2d.dtype],
                             _vec(x2d, y, scale, shift), _stream(x2d))
    _build.check(rc, "bn_act")
    LAUNCHES += 1
    return y


def bn_stats(x2d, center, gamma, beta, eps: float = 1e-5):
    """The stats kernel, one launch → (7, C) f32, rows ``STATS_ROWS``:
    [Σd; Σd²; mean; var; inv; scale; shift], d = x − center, mean and var
    as :func:`_finish_moments`, inv = rsqrt(var + eps), scale and shift as
    :func:`_scale_shift`."""
    global LAUNCHES_STATS
    _check_rows("x2d", x2d)
    _check_vecs(x2d, center=center, gamma=gamma, beta=beta)
    n, c = x2d.shape
    vec = _vec(x2d)
    out = torch.empty((len(STATS_ROWS), c), dtype=torch.float32,
                      device=x2d.device)
    partial, counters, plan, stream = _workspace(x2d, vec, "stats")
    rc = _load().dl4j_bn_stats(
        x2d.data_ptr(), center.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
        partial.data_ptr(), out.data_ptr(), counters.data_ptr(), n, c,
        _DTYPES[x2d.dtype], vec, *plan, float(eps), stream)
    _build.check(rc, "bn_stats")
    LAUNCHES_STATS += 1
    return out


def bn_bwd_reduce(x2d, g, scale, shift, mean, inv, activation):
    """The backward reduce kernel, one launch → (4, C) f32, rows
    ``BWD_REDUCE_ROWS``: [Σdz; Σdz·x̂; Σdz/N; Σdz·x̂/N] (dβ, dγ, and the
    dx kernel's ``corr``)."""
    global LAUNCHES_BWD_REDUCE
    _check_train_act(activation)
    _check_rows("x2d", x2d)
    _check_rows("g", g, like=x2d)
    _check_vecs(x2d, scale=scale, shift=shift, mean=mean, inv=inv)
    n, c = x2d.shape
    vec = _vec(x2d, g)
    out = torch.empty((len(BWD_REDUCE_ROWS), c), dtype=torch.float32,
                      device=x2d.device)
    partial, counters, plan, stream = _workspace(x2d, vec, "bwd_reduce")
    rc = _load().dl4j_bn_bwd_reduce(
        x2d.data_ptr(), g.data_ptr(), scale.data_ptr(), shift.data_ptr(),
        mean.data_ptr(), inv.data_ptr(), partial.data_ptr(), out.data_ptr(),
        counters.data_ptr(), n, c, _ACT_CODES[activation],
        _DTYPES[x2d.dtype], vec, *plan, stream)
    _build.check(rc, "bn_bwd_reduce")
    LAUNCHES_BWD_REDUCE += 1
    return out


def _workspace(x2d, vec, kernel):
    """The ``kernel`` reduction's plan over x2d's rows
    (:func:`reduce_plan`), its (G, 2, C) f32 workspace and this stream's
    arrival counters → (partial, counters, (tcv, rows, G), stream)."""
    n, c = x2d.shape
    width = _VEC[x2d.dtype] if vec else 1
    plan = reduce_plan(n, c, width, _DEPTH[kernel])
    tiles = -(-(-(-c // width)) // plan[0])     # ceil(ceil(c / width) / tcv)
    partial = torch.empty((plan[2], 2, c), dtype=torch.float32,
                          device=x2d.device)
    stream = _stream(x2d)
    return partial, _counters(x2d.device, stream, tiles), plan, stream


#: (device index, stream) → the int32 arrival counters of the reduction
#: kernels, one per channel tile: zeroed once, left zero by every launch
_COUNTERS = {}


def _counters(device, stream, tiles):
    """This stream's counters, allocated on its first use. A CUDA graph
    capture must find them allocated (by an eager step on the capture
    stream, as ``nn/_compiled.py`` runs first): allocated inside the
    capture they would come from the graph's pool and be zeroed only by
    the capture's own memset."""
    key = (device.index, stream)
    buf = _COUNTERS.get(key)
    if buf is None or buf.numel() < tiles:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "K3's arrival counters for the capturing stream are not "
                f"allocated for {tiles} channel tiles: run one eager step "
                "on that stream before the capture")
        buf = torch.zeros(max(64, tiles), dtype=torch.int32, device=device)
        _COUNTERS[key] = buf
    return buf


def bn_bwd_dx(x2d, g, scale, shift, mean, inv, corr, activation):
    """The dx kernel: scale·(dz − corr[0] − x̂·corr[1]) in x's dtype,
    ``corr`` = [Σdz; Σdz·x̂]/N (2, C) f32."""
    global LAUNCHES_BWD_DX
    _check_train_act(activation)
    _check_rows("x2d", x2d)
    _check_rows("g", g, like=x2d)
    _check_vecs(x2d, scale=scale, shift=shift, mean=mean, inv=inv)
    if corr.shape != (2, x2d.shape[1]) or corr.dtype != torch.float32 \
            or not corr.is_contiguous() or corr.device != x2d.device:
        raise ValueError("corr must be a contiguous (2, C) f32 tensor on "
                         "x's device")
    dx = torch.empty_like(x2d)
    n, c = x2d.shape
    rc = _load().dl4j_bn_bwd_dx(
        x2d.data_ptr(), g.data_ptr(), scale.data_ptr(), shift.data_ptr(),
        mean.data_ptr(), inv.data_ptr(), corr.data_ptr(), dx.data_ptr(), n,
        c, _ACT_CODES[activation], _DTYPES[x2d.dtype],
        _vec(x2d, g, dx, scale, shift, mean, inv, corr), _stream(x2d))
    _build.check(rc, "bn_bwd_dx")
    LAUNCHES_BWD_DX += 1
    return dx


def reduce_plan(n: int, c: int, width: int, depth: int):
    """(channel vectors per tile, rows per chunk, chunks G) of a
    reduction. A block of 256 threads covers ``tcv`` channel vectors of
    ``width`` elements (a 128-byte row segment of 16-byte vectors, or 32
    channels) × 256//tcv row lanes over its chunk of rows; G is the
    fewest of: the chunks that give every block at least
    ``_MIN_BLOCK_ELEMS`` elements, the chunks that fill the card ``depth``
    blocks deep in one wave (``_SMS * depth`` blocks over the channel
    tiles), and one per row lane. Depends on (n, c, width) and the
    kernel's depth only, so the summation order — and the sums — repeat
    exactly from launch to launch."""
    cv = -(-c // width)
    tcv = min(cv, _TILE_VECS if width > 1 else _TILE_SCALARS)
    lanes = _THREADS // tcv
    tiles = -(-cv // tcv)
    by_bytes = n * tcv * width // _MIN_BLOCK_ELEMS
    chunks = max(1, min(by_bytes, _SMS * depth // tiles, -(-n // lanes)))
    rows = -(-n // chunks)
    return tcv, rows, -(-n // rows)


def _check_train_act(activation):
    if not supported_train_activation(activation):
        raise ValueError(f"activation {activation!r} has no BN backward "
                         "kernel")


def _check_rows(name, t, like=None):
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dim() != 2:
        raise ValueError(f"{name} must be an (N, C) view, got "
                         f"{tuple(t.shape)}")
    if t.dtype not in _DTYPES:
        raise ValueError(f"{name}: the kernels take float32 or bfloat16 "
                         f"rows, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous (N, C) view")
    if like is not None and (t.shape != like.shape or t.dtype != like.dtype
                             or t.device != like.device):
        raise ValueError(f"{name} {tuple(t.shape)} {t.dtype} must match x "
                         f"{tuple(like.shape)} {like.dtype}")
    if t.numel() >= 2 ** 31 or t.shape[0] < 1 or t.shape[1] < 1:
        raise ValueError(f"{name}: the kernels take 1 <= N, C and "
                         f"N*C < 2**31, got {tuple(t.shape)}")


def _check_vecs(x2d, **vecs):
    c = x2d.shape[1]
    for name, v in vecs.items():
        if v.shape != (c,) or v.dtype != torch.float32 \
                or not v.is_contiguous() or v.device != x2d.device:
            raise ValueError(f"{name} must be a contiguous ({c},) f32 "
                             f"tensor on {x2d.device}, got "
                             f"{tuple(v.shape)} {v.dtype} on {v.device}")


def _vec(x, *others):
    """1 when the 16-byte access applies: C a multiple of x's vector
    width and every pointer (rows and per-channel vectors) 16-byte
    aligned."""
    if x.shape[1] % _VEC[x.dtype]:
        return 0
    return int(all(t.data_ptr() % 16 == 0 for t in (x, *others)))


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _load():
    lib = _build.load(_SOURCE)
    if lib.dl4j_bn_act.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.dl4j_bn_act.argtypes = [p, p, p, p, i, i, i, i, i, p]
        f = ctypes.c_float
        lib.dl4j_bn_stats.argtypes = [p] * 7 + [i] * 7 + [f, p]
        lib.dl4j_bn_bwd_reduce.argtypes = [p] * 9 + [i] * 8 + [p]
        lib.dl4j_bn_bwd_dx.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i,
                                       i, p]
        for fn in (lib.dl4j_bn_act, lib.dl4j_bn_stats,
                   lib.dl4j_bn_bwd_reduce, lib.dl4j_bn_bwd_dx):
            fn.restype = i
    return lib


"""Nd4j random — port of ``deeplearning4j_tpu/ndarray/random.py``
(``Nd4j.rand/randn`` and ``org.nd4j.linalg.api.rng``).

The reference passes JAX PRNG keys. Here a key is a ``torch.Generator``:

- :func:`key` ``(seed, device=None)`` returns a generator seeded with
  ``seed`` on ``device`` (None → the CUDA card); the distributions draw
  on the key's device, from the key;
- :func:`split` and :func:`fold_in` derive new seeded generators from a
  key's seed, deterministically and without drawing from it (a key split
  twice gives the same children, as in JAX);
- unlike a JAX key, a generator advances when it is drawn from: two draws
  from one key differ.

The stateful facade (:func:`set_seed`, the keyless :func:`rand`,
:func:`randn`, :func:`shuffle`, :func:`next_key`) draws from one module
generator on the host, created on first use and never at import; its
draws are moved to ``device``, so a seed gives the same values on the
host and on the card.

The port cannot reproduce JAX's bit streams. Parity with the reference
means the same shapes, dtypes and supports, moments within a stated
tolerance, and the same draws from the same seed.
"""

from __future__ import annotations

import threading

import torch

from .._device import resolve_device
from .factory import _as_dtype, _t

_lock = threading.Lock()
_state = {"gen": None}
_MASK64 = (1 << 64) - 1


def _mix(x: int) -> int:
    """splitmix64's finalizer: a seed from an integer."""
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (x ^ (x >> 31)) & ((1 << 63) - 1)


def set_seed(seed: int) -> None:
    """Nd4j.getRandom().setSeed (the facade's host generator)."""
    with _lock:
        _state["gen"] = torch.Generator().manual_seed(int(seed))


def _module_gen():
    if _state["gen"] is None:
        _state["gen"] = torch.Generator().manual_seed(0)
    return _state["gen"]


def key(seed: int, device=None):
    """A generator seeded with ``seed`` on ``device`` (None → the card)."""
    return torch.Generator(device=resolve_device(device)).manual_seed(
        int(seed))


def next_key(device=None):
    """A fresh key seeded from the facade's stream."""
    with _lock:
        seed = int(torch.randint(0, 2**62, (), generator=_module_gen()))
    return key(seed, device)


def split(k, num: int = 2):
    """``num`` new keys on ``k``'s device, derived from its seed."""
    base = k.initial_seed()
    return [torch.Generator(device=k.device).manual_seed(
        _mix(_mix(base) ^ (i + 1))) for i in range(num)]


def fold_in(k, data: int):
    """A new key on ``k``'s device from its seed and ``data``."""
    return torch.Generator(device=k.device).manual_seed(
        _mix(_mix(k.initial_seed()) ^ _mix(int(data) + 0x5851F42D)))


def _size(shape):
    return (shape,) if isinstance(shape, int) else tuple(shape)


def _dtype(dtype):
    return _as_dtype(dtype) or torch.float32


# --- explicit-key distributions --------------------------------------------

def uniform(k, shape=(), dtype=torch.float32, minval=0.0, maxval=1.0):
    u = torch.rand(_size(shape), generator=k, device=k.device,
                   dtype=_dtype(dtype))
    return u * (maxval - minval) + minval


def normal(k, shape=(), dtype=torch.float32, mean=0.0, std=1.0):
    return mean + std * torch.randn(_size(shape), generator=k,
                                    device=k.device, dtype=_dtype(dtype))


def truncated_normal(k, shape=(), dtype=torch.float32, lower=-2.0,
                     upper=2.0, mean=0.0, std=1.0):
    """``mean + std·z``, z standard normal truncated to [lower, upper]."""
    z = torch.empty(_size(shape), device=k.device, dtype=torch.float32)
    torch.nn.init.trunc_normal_(z, 0.0, 1.0, lower, upper, generator=k)
    return (mean + std * z).to(_dtype(dtype))


def bernoulli(k, p=0.5, shape=()):
    return torch.rand(_size(shape), generator=k, device=k.device) < p


def binomial(k, n, p, shape=(), dtype=torch.int32):
    count = torch.full(_size(shape), float(n), device=k.device)
    return torch.binomial(count, torch.full_like(count, float(p)),
                          generator=k).to(_dtype(dtype))


def _std_gamma(k, alpha, shape):
    """Marsaglia and Tsang's Gamma(alpha, 1) draws, alpha < 1 boosted by
    U^(1/alpha); rejection rounds until every entry is accepted."""
    alpha = torch.broadcast_to(_t(alpha).to(device=k.device,
                                            dtype=torch.float32), shape)
    boost = alpha < 1
    a = torch.where(boost, alpha + 1, alpha)
    d = a - 1.0 / 3.0
    c = 1.0 / torch.sqrt(9.0 * d)
    out = torch.zeros(shape, device=k.device)
    todo = torch.ones(shape, dtype=torch.bool, device=k.device)
    while bool(todo.any()):
        z = torch.randn(shape, generator=k, device=k.device)
        u = torch.rand(shape, generator=k, device=k.device)
        v = (1 + c * z) ** 3
        ok = (v > 0) & (torch.log(u.clamp_min(1e-38))
                        < 0.5 * z * z + d - d * v
                        + d * torch.log(v.clamp_min(1e-38)))
        take = todo & ok
        out = torch.where(take, d * v, out)
        todo = todo & ~ok
    u = torch.rand(shape, generator=k, device=k.device)
    return torch.where(boost, out * u.clamp_min(1e-38) ** (1.0 / alpha), out)


def gamma(k, alpha, shape=(), dtype=torch.float32):
    return _std_gamma(k, alpha, _size(shape)).to(_dtype(dtype))


def beta(k, a, b, shape=(), dtype=torch.float32):
    x = _std_gamma(k, a, _size(shape))
    y = _std_gamma(k, b, _size(shape))
    return (x / (x + y)).to(_dtype(dtype))


def exponential(k, shape=(), dtype=torch.float32, rate=1.0):
    e = torch.empty(_size(shape), device=k.device, dtype=_dtype(dtype))
    return e.exponential_(generator=k) / rate


def poisson(k, lam, shape=(), dtype=torch.int32):
    rates = torch.broadcast_to(
        _t(lam).to(device=k.device, dtype=torch.float32), _size(shape))
    return torch.poisson(rates.contiguous(), generator=k).to(_dtype(dtype))


def randint(k, shape, minval, maxval, dtype=torch.int32):
    return torch.randint(minval, maxval, _size(shape), generator=k,
                         device=k.device, dtype=_dtype(dtype))


def gumbel(k, shape=(), dtype=torch.float32):
    u = torch.rand(_size(shape), generator=k, device=k.device)
    u = u.clamp(torch.finfo(torch.float32).tiny, 1.0 - 1e-7)
    return (-torch.log(-torch.log(u))).to(_dtype(dtype))


def laplace(k, shape=(), dtype=torch.float32):
    u = torch.rand(_size(shape), generator=k, device=k.device) - 0.5
    return (-torch.sign(u) * torch.log1p(-2 * u.abs().clamp_max(
        0.5 - 1e-7))).to(_dtype(dtype))


def categorical(k, logits, axis=-1, shape=None):
    """Draws of category indices from ``logits`` (Gumbel-max, as JAX);
    ``shape`` the batch shape (``logits`` without ``axis``, broadcast)."""
    logits = torch.movedim(_t(logits).to(k.device), axis, -1)
    batch = tuple(logits.shape[:-1]) if shape is None else _size(shape)
    g = gumbel(k, batch + (logits.shape[-1],))
    return torch.argmax(logits + g, dim=-1).to(torch.int32)


def permutation(k, x, axis=0):
    """A permutation of ``range(x)`` (an int), or of ``x`` along ``axis``."""
    if isinstance(x, int):
        return torch.randperm(x, generator=k, device=k.device).to(
            torch.int32)
    x = _t(x).to(k.device)
    idx = torch.randperm(x.shape[axis], generator=k, device=k.device)
    return torch.index_select(x, axis, idx)


def choice(k, a, shape=(), replace=True, p=None):
    """Draws from ``a`` (an int: ``range(a)``), with or without
    replacement, uniform or by the probabilities ``p``."""
    pool = torch.arange(a, device=k.device, dtype=torch.int32) \
        if isinstance(a, int) else _t(a).to(k.device)
    n = 1
    for s in _size(shape):
        n *= s
    size = pool.shape[0]
    if p is not None:
        idx = torch.multinomial(_t(p).to(device=k.device,
                                         dtype=torch.float32), n,
                                replacement=replace, generator=k)
    elif replace:
        idx = torch.randint(0, size, (n,), generator=k, device=k.device)
    else:
        idx = torch.randperm(size, generator=k, device=k.device)[:n]
    return pool[idx].reshape(_size(shape) + tuple(pool.shape[1:]))


# --- stateful facade (Nd4j.rand/randn; host generator) ---------------------

def _host_draw(fn, device):
    with _lock:
        out = fn(_module_gen())
    return out.to(resolve_device(device))


def rand(*shape, dtype=torch.float32, minval=0.0, maxval=1.0, device=None):
    shape = shape[0] if len(shape) == 1 and isinstance(
        shape[0], (tuple, list)) else shape
    return _host_draw(lambda g: uniform(g, shape, dtype, minval, maxval),
                      device)


def randn(*shape, dtype=torch.float32, device=None):
    shape = shape[0] if len(shape) == 1 and isinstance(
        shape[0], (tuple, list)) else shape
    return _host_draw(lambda g: normal(g, shape, dtype), device)


def shuffle(x, axis=0):
    """``x`` permuted along ``axis`` on its own device."""
    x = _t(x)
    with _lock:
        idx = torch.randperm(x.shape[axis], generator=_module_gen())
    return torch.index_select(x, axis, idx.to(x.device))

"""Weight initialization — port of ``deeplearning4j_tpu/nn/weights.py``
(DL4J's ``WeightInit``).

Each initializer is ``fn(gen, shape, fan_in, fan_out, dtype) -> tensor``
and draws on the host from the ``torch.Generator`` it is given, so the
same seed gives the same weights whatever device the net lives on. The
draws are not JAX's bits (another generator); parity with the reference
goes through shared weights (``nn.computation_graph.params_from_numpy``).
DL4J fan semantics: for dense W of shape (nIn, nOut), fan_in=nIn,
fan_out=nOut; for convs (kh,kw,cin,cout): fan_in=kh*kw*cin,
fan_out=kh*kw*cout.
"""

from __future__ import annotations

import math

import torch


def compute_fans(shape):
    if len(shape) == 0:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    receptive = math.prod(shape[:-2])
    return shape[-2] * receptive, shape[-1] * receptive


def _normal(gen, shape, dtype):
    return torch.randn(tuple(shape), generator=gen, dtype=dtype)


def _uniform(gen, shape, dtype, lo, hi):
    return torch.empty(tuple(shape), dtype=dtype).uniform_(lo, hi,
                                                           generator=gen)


def _truncated(gen, shape, dtype):
    """N(0, 1) truncated to [-2, 2]."""
    t = torch.empty(tuple(shape), dtype=torch.float32)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return t.to(dtype)


def zero(gen, shape, fan_in, fan_out, dtype=torch.float32):
    return torch.zeros(tuple(shape), dtype=dtype)


def one(gen, shape, fan_in, fan_out, dtype=torch.float32):
    return torch.ones(tuple(shape), dtype=dtype)


def constant(value):
    def init(gen, shape, fan_in, fan_out, dtype=torch.float32):
        return torch.full(tuple(shape), value, dtype=dtype)
    return init


def normal(gen, shape, fan_in, fan_out, dtype=torch.float32):
    """DL4J NORMAL: N(0, 1/sqrt(fanIn))."""
    return _normal(gen, shape, dtype) / math.sqrt(fan_in)


def gaussian(gen, shape, fan_in, fan_out, dtype=torch.float32):
    """DL4J (legacy) DISTRIBUTION-free gaussian: N(0,1)."""
    return _normal(gen, shape, dtype)


def truncated_normal(gen, shape, fan_in, fan_out, dtype=torch.float32,
                     std=1.0):
    return std * _truncated(gen, shape, dtype)


def uniform(gen, shape, fan_in, fan_out, dtype=torch.float32):
    """DL4J UNIFORM: U(-a, a), a = sqrt(3/fanIn)."""
    a = math.sqrt(3.0 / fan_in)
    return _uniform(gen, shape, dtype, -a, a)


def xavier(gen, shape, fan_in, fan_out, dtype=torch.float32):
    """DL4J XAVIER: N(0, 2/(fanIn+fanOut))."""
    std = math.sqrt(2.0 / (fan_in + fan_out))
    return std * _normal(gen, shape, dtype)


def xavier_uniform(gen, shape, fan_in, fan_out, dtype=torch.float32):
    a = math.sqrt(6.0 / (fan_in + fan_out))
    return _uniform(gen, shape, dtype, -a, a)


def xavier_fan_in(gen, shape, fan_in, fan_out, dtype=torch.float32):
    return _normal(gen, shape, dtype) / math.sqrt(fan_in)


def xavier_legacy(gen, shape, fan_in, fan_out, dtype=torch.float32):
    std = math.sqrt(1.0 / (fan_in + fan_out))
    return std * _normal(gen, shape, dtype)


def relu_init(gen, shape, fan_in, fan_out, dtype=torch.float32):
    """DL4J RELU == He normal: N(0, 2/fanIn)."""
    return math.sqrt(2.0 / fan_in) * _normal(gen, shape, dtype)


def relu_uniform(gen, shape, fan_in, fan_out, dtype=torch.float32):
    a = math.sqrt(6.0 / fan_in)
    return _uniform(gen, shape, dtype, -a, a)


he_normal = relu_init
he_uniform = relu_uniform


def lecun_normal(gen, shape, fan_in, fan_out, dtype=torch.float32):
    return math.sqrt(1.0 / fan_in) * _normal(gen, shape, dtype)


def lecun_uniform(gen, shape, fan_in, fan_out, dtype=torch.float32):
    a = math.sqrt(3.0 / fan_in)
    return _uniform(gen, shape, dtype, -a, a)


def sigmoid_uniform(gen, shape, fan_in, fan_out, dtype=torch.float32):
    a = 4.0 * math.sqrt(6.0 / (fan_in + fan_out))
    return _uniform(gen, shape, dtype, -a, a)


def orthogonal(gen, shape, fan_in, fan_out, dtype=torch.float32, gain=1.0):
    if len(shape) < 2:
        return _normal(gen, shape, dtype)
    rows = math.prod(shape[:-1])
    cols = shape[-1]
    a = _normal(gen, (max(rows, cols), min(rows, cols)), torch.float32)
    q, r = torch.linalg.qr(a)
    q = q * torch.sign(torch.diagonal(r))
    q = q.T if rows < cols else q
    return (gain * q[:rows, :cols]).reshape(tuple(shape)).to(dtype)


def identity_init(gen, shape, fan_in, fan_out, dtype=torch.float32):
    if len(shape) == 2:
        return torch.eye(shape[0], shape[1], dtype=dtype)
    # conv identity: delta kernel at spatial center
    w = torch.zeros(tuple(shape), dtype=dtype)
    ctr = tuple(s // 2 for s in shape[:-2])
    w[ctr] = torch.eye(shape[-2], shape[-1], dtype=dtype)
    return w


def var_scaling(scale=1.0, mode="fan_in", distribution="truncated_normal"):
    """VAR_SCALING_* family."""
    def init(gen, shape, fan_in, fan_out, dtype=torch.float32):
        if mode == "fan_in":
            n = fan_in
        elif mode == "fan_out":
            n = fan_out
        else:
            n = (fan_in + fan_out) / 2.0
        variance = scale / max(1.0, n)
        if distribution == "truncated_normal":
            std = math.sqrt(variance) / 0.8796256610342398  # correct truncation
            return std * _truncated(gen, shape, dtype)
        if distribution == "normal":
            return math.sqrt(variance) * _normal(gen, shape, dtype)
        a = math.sqrt(3.0 * variance)
        return _uniform(gen, shape, dtype, -a, a)
    return init


_REGISTRY = {
    "zero": zero, "ones": one, "one": one,
    "normal": normal, "gaussian": gaussian, "truncated_normal": truncated_normal,
    "uniform": uniform,
    "xavier": xavier, "xavier_uniform": xavier_uniform,
    "xavier_fan_in": xavier_fan_in, "xavier_legacy": xavier_legacy,
    "relu": relu_init, "relu_uniform": relu_uniform,
    "he_normal": he_normal, "he_uniform": he_uniform,
    "lecun_normal": lecun_normal, "lecun_uniform": lecun_uniform,
    "sigmoid_uniform": sigmoid_uniform,
    "orthogonal": orthogonal, "identity": identity_init,
    "var_scaling_normal_fan_in": var_scaling(1.0, "fan_in", "normal"),
    "var_scaling_normal_fan_out": var_scaling(1.0, "fan_out", "normal"),
    "var_scaling_normal_fan_avg": var_scaling(1.0, "fan_avg", "normal"),
    "var_scaling_uniform_fan_in": var_scaling(1.0, "fan_in", "uniform"),
    "var_scaling_uniform_fan_out": var_scaling(1.0, "fan_out", "uniform"),
    "var_scaling_uniform_fan_avg": var_scaling(1.0, "fan_avg", "uniform"),
}


class WeightInit:
    """DL4J-style enum constants: WeightInit.XAVIER etc. (string-valued)."""

    ZERO = "zero"
    ONES = "ones"
    NORMAL = "normal"
    TRUNCATED_NORMAL = "truncated_normal"
    UNIFORM = "uniform"
    XAVIER = "xavier"
    XAVIER_UNIFORM = "xavier_uniform"
    XAVIER_FAN_IN = "xavier_fan_in"
    XAVIER_LEGACY = "xavier_legacy"
    RELU = "relu"
    RELU_UNIFORM = "relu_uniform"
    HE_NORMAL = "he_normal"
    HE_UNIFORM = "he_uniform"
    LECUN_NORMAL = "lecun_normal"
    LECUN_UNIFORM = "lecun_uniform"
    SIGMOID_UNIFORM = "sigmoid_uniform"
    ORTHOGONAL = "orthogonal"
    IDENTITY = "identity"


def get(name_or_fn):
    if callable(name_or_fn):
        return name_or_fn
    key = str(name_or_fn).lower()
    if key not in _REGISTRY:
        raise ValueError(f"Unknown weight init '{name_or_fn}'. Known: {sorted(_REGISTRY)}")
    return _REGISTRY[key]

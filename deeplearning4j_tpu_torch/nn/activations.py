"""Activation functions — port of ``deeplearning4j_tpu/nn/activations.py``
(DL4J's ``Activation`` enum, lowercase names).

Pure elementwise torch functions. ``gelu`` is the tanh approximation, as
in the reference (DL4J's GELU default); ``gelu_exact`` is the erf form.
Resolve by name with :func:`get`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def identity(x):
    return x


def relu(x):
    return F.relu(x)


def relu6(x):
    return F.relu6(x)


def leakyrelu(x, alpha=0.01):
    return torch.where(x >= 0, x, alpha * x)


def elu(x, alpha=1.0):
    return F.elu(x, alpha)


def selu(x):
    return F.selu(x)


def celu(x, alpha=1.0):
    return F.celu(x, alpha)


def gelu(x):
    """DL4J ActivationGELU (tanh approximation is its default path)."""
    return F.gelu(x, approximate="tanh")


def gelu_exact(x):
    return F.gelu(x)


def sigmoid(x):
    return torch.sigmoid(x)


def hardsigmoid(x):
    return torch.clamp(0.2 * x + 0.5, 0.0, 1.0)


def softmax(x, axis=-1):
    return torch.softmax(x, dim=axis)


def logsoftmax(x, axis=-1):
    return torch.log_softmax(x, dim=axis)


def tanh(x):
    return torch.tanh(x)


def rationaltanh(x):
    """DL4J ActivationRationalTanh: 1.7159 * tanh(2x/3) rational approximation."""
    ax = torch.abs(x)
    a = 1.0 + ax + x * x + 1.41645 * x * x * x * x
    return torch.sign(x) * (1.0 - 1.0 / a) * 1.7159


def rectifiedtanh(x):
    return torch.clamp(torch.tanh(x), min=0.0)


def hardtanh(x):
    return torch.clamp(x, -1.0, 1.0)


def softplus(x):
    """logaddexp(x, 0), the stable form of log(1 + e^x)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def softsign(x):
    return x / (1.0 + torch.abs(x))


def swish(x):
    return F.silu(x)


def mish(x):
    return x * torch.tanh(softplus(x))


def cube(x):
    return x * x * x


def thresholdedrelu(x, theta=1.0):
    return torch.where(x > theta, x, torch.zeros_like(x))


def gumbel_softmax(x, tau=1.0, axis=-1):
    return torch.softmax(x / tau, dim=axis)


_REGISTRY = {
    "identity": identity, "linear": identity,
    "relu": relu, "relu6": relu6, "leakyrelu": leakyrelu, "elu": elu,
    "selu": selu, "celu": celu, "gelu": gelu, "gelu_exact": gelu_exact,
    "sigmoid": sigmoid, "hardsigmoid": hardsigmoid,
    "softmax": softmax, "logsoftmax": logsoftmax,
    "tanh": tanh, "rationaltanh": rationaltanh, "rectifiedtanh": rectifiedtanh,
    "hardtanh": hardtanh, "softplus": softplus, "softsign": softsign,
    "swish": swish, "silu": swish, "mish": mish, "cube": cube,
    "thresholdedrelu": thresholdedrelu, "gumbel_softmax": gumbel_softmax,
}


def get(name_or_fn):
    """Resolve an activation by DL4J enum name (case-insensitive) or pass through."""
    if callable(name_or_fn):
        return name_or_fn
    key = str(name_or_fn).lower()
    if key not in _REGISTRY:
        raise ValueError(f"Unknown activation '{name_or_fn}'. Known: {sorted(_REGISTRY)}")
    return _REGISTRY[key]


def names():
    return sorted(_REGISTRY)

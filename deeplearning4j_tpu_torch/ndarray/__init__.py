"""``deeplearning4j_tpu_torch.ndarray`` — the ND4J tensor layer of the
port (``deeplearning4j_tpu.ndarray``'s counterpart).

Usage: ``from deeplearning4j_tpu_torch import nd`` then
``nd.zeros(3, 4, device="cpu")``, ``nd.mmul(a, b)``,
``nd.random.randn(2, 2)``. Arrays are plain ``torch.Tensor``s.
"""

from . import indexing, random, workspace
from .factory import *  # noqa: F401,F403 — the Nd4j-style flat namespace
from .factory import linalg  # noqa: F401

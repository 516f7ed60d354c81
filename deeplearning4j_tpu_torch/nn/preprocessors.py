"""Input preprocessors — port of ``deeplearning4j_tpu/nn/preprocessors.py``
(``org.deeplearning4j.nn.conf.preprocessor.*PreProcessor``): pure
reshapes between layer families, auto-inserted by the network where
adjacent shape kinds differ.
"""

from __future__ import annotations

import math
from dataclasses import dataclass


@dataclass
class CnnToFeedForwardPreProcessor:
    def out_shape(self, s):
        return (int(math.prod(s)),)

    def __call__(self, x):
        return x.reshape(x.shape[0], -1)


@dataclass
class FeedForwardToCnnPreProcessor:
    height: int = 0
    width: int = 0
    channels: int = 0

    def out_shape(self, s):
        return (self.height, self.width, self.channels)

    def __call__(self, x):
        return x.reshape(x.shape[0], self.height, self.width, self.channels)


@dataclass
class RnnToFeedForwardPreProcessor:
    """(B,T,C) → (B*T, C); pairs with FeedForwardToRnn to restore."""

    def out_shape(self, s):
        return (s[-1],)

    def __call__(self, x):
        return x.reshape(-1, x.shape[-1])


@dataclass
class FeedForwardToRnnPreProcessor:
    timesteps: int = 0

    def out_shape(self, s):
        return (self.timesteps, s[-1])

    def __call__(self, x):
        return x.reshape(-1, self.timesteps, x.shape[-1])


@dataclass
class CnnToRnnPreProcessor:
    """(B,H,W,C) → (B, H, W*C) treating H as time."""

    def out_shape(self, s):
        h, w, c = s
        return (h, w * c)

    def __call__(self, x):
        b, h, w, c = x.shape
        return x.reshape(b, h, w * c)


@dataclass
class RnnToCnnPreProcessor:
    height: int = 0
    width: int = 0
    channels: int = 0

    def out_shape(self, s):
        return (self.height, self.width, self.channels)

    def __call__(self, x):
        return x.reshape(x.shape[0], self.height, self.width, self.channels)

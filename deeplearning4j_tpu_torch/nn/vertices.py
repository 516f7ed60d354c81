"""Graph vertices — port of ``deeplearning4j_tpu/nn/vertices.py``
(``org.deeplearning4j.nn.conf.graph.*Vertex``).

MergeVertex, ElementWiseVertex, SubsetVertex, StackVertex, UnstackVertex,
L2NormalizeVertex, L2Vertex, ScaleVertex, ShiftVertex, ReshapeVertex,
PreprocessorVertex. A vertex is param-free; ``apply(inputs: list) ->
tensor`` and ``out_shape(shapes: list) -> shape``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, Tuple

import torch


class GraphVertex:
    def out_shape(self, shapes: List[Tuple]) -> Tuple:
        raise NotImplementedError

    def apply(self, inputs: List, ctx=None):
        raise NotImplementedError


@dataclass
class MergeVertex(GraphVertex):
    """Concat along feature (last) axis."""

    axis: int = -1

    def out_shape(self, shapes):
        base = list(shapes[0])
        base[-1] = sum(s[-1] for s in shapes)
        return tuple(base)

    def apply(self, inputs, ctx=None):
        return torch.cat(inputs, dim=self.axis)


@dataclass
class ElementWiseVertex(GraphVertex):
    """op in {add, sub, mul, avg, max} (reference ElementWiseVertex.Op)."""

    op: str = "add"

    def out_shape(self, shapes):
        return shapes[0]

    def apply(self, inputs, ctx=None):
        x = inputs[0]
        if self.op == "add":
            for y in inputs[1:]:
                x = x + y
        elif self.op == "sub":
            x = x - inputs[1]
        elif self.op == "mul":
            for y in inputs[1:]:
                x = x * y
        elif self.op == "avg":
            x = sum(inputs) / len(inputs)
        elif self.op == "max":
            for y in inputs[1:]:
                x = torch.maximum(x, y)
        else:
            raise ValueError(self.op)
        return x


@dataclass
class SubsetVertex(GraphVertex):
    """Feature-axis slice [lo, hi] inclusive (reference semantics)."""

    lo: int = 0
    hi: int = 0

    def out_shape(self, shapes):
        s = list(shapes[0])
        s[-1] = self.hi - self.lo + 1
        return tuple(s)

    def apply(self, inputs, ctx=None):
        return inputs[0][..., self.lo:self.hi + 1]


@dataclass
class StackVertex(GraphVertex):
    """Stack along batch axis (reference StackVertex)."""

    def out_shape(self, shapes):
        return shapes[0]

    def apply(self, inputs, ctx=None):
        return torch.cat(inputs, dim=0)


@dataclass
class UnstackVertex(GraphVertex):
    from_index: int = 0
    stack_size: int = 1

    def out_shape(self, shapes):
        return shapes[0]

    def apply(self, inputs, ctx=None):
        x = inputs[0]
        n = x.shape[0] // self.stack_size
        return x[self.from_index * n:(self.from_index + 1) * n]


@dataclass
class L2NormalizeVertex(GraphVertex):
    eps: float = 1e-8

    def out_shape(self, shapes):
        return shapes[0]

    def apply(self, inputs, ctx=None):
        x = inputs[0]
        n = torch.sqrt(torch.sum(torch.square(x), dim=-1, keepdim=True))
        return x / torch.clamp(n, min=self.eps)


@dataclass
class L2Vertex(GraphVertex):
    """Pairwise L2 distance between two inputs → (B, 1)."""

    eps: float = 1e-8

    def out_shape(self, shapes):
        return (1,)

    def apply(self, inputs, ctx=None):
        a, b = inputs
        d = a.reshape(a.shape[0], -1) - b.reshape(b.shape[0], -1)
        return torch.sqrt(torch.sum(torch.square(d), dim=-1, keepdim=True)
                          + self.eps)


@dataclass
class ScaleVertex(GraphVertex):
    scale: float = 1.0

    def out_shape(self, shapes):
        return shapes[0]

    def apply(self, inputs, ctx=None):
        return inputs[0] * self.scale


@dataclass
class ShiftVertex(GraphVertex):
    shift: float = 0.0

    def out_shape(self, shapes):
        return shapes[0]

    def apply(self, inputs, ctx=None):
        return inputs[0] + self.shift


@dataclass
class ReshapeVertex(GraphVertex):
    new_shape: Tuple = ()  # excluding batch

    def out_shape(self, shapes):
        return tuple(self.new_shape)

    def apply(self, inputs, ctx=None):
        x = inputs[0]
        return x.reshape((x.shape[0],) + tuple(self.new_shape))


@dataclass
class PreprocessorVertex(GraphVertex):
    preprocessor: Any = None

    def out_shape(self, shapes):
        return self.preprocessor.out_shape(shapes[0])

    def apply(self, inputs, ctx=None):
        return self.preprocessor(inputs[0])

"""ComputationGraphConfiguration builder — port of
``deeplearning4j_tpu/nn/graph.py`` (``GraphBuilder``: addInputs /
addLayer / addVertex / setOutputs / setInputTypes). The DAG is validated
and topologically sorted at build time; ``to_upstream_json`` /
``from_upstream_json`` are the upstream DL4J format
(``serde/upstream_dl4j.py``).
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

from .conf import GlobalConf, resolve_layer_defaults
from .layers.base import Layer
from .vertices import GraphVertex


@dataclass
class NodeDef:
    name: str
    op: Any                      # Layer | GraphVertex
    inputs: List[str]


@dataclass
class ComputationGraphConfiguration:
    globals_: GlobalConf
    inputs: List[str]
    outputs: List[str]
    nodes: Dict[str, NodeDef]
    topo_order: List[str]
    input_types: Optional[List] = None

    def to_upstream_json(self) -> str:
        """Upstream ``ComputationGraphConfiguration.toJson()``-format JSON
        (serde/upstream_dl4j.py, supported layer/vertex subset)."""
        from ..serde.upstream_dl4j import cg_conf_to_upstream_json
        return cg_conf_to_upstream_json(self)

    @staticmethod
    def from_upstream_json(data: str) -> "ComputationGraphConfiguration":
        """Upstream ``ComputationGraphConfiguration.fromJson()`` analogue."""
        from ..serde.upstream_dl4j import cg_conf_from_upstream_json
        return cg_conf_from_upstream_json(data)

    fromJson = from_upstream_json      # reference naming


class GraphBuilder:
    def __init__(self, g: GlobalConf):
        self._g = g
        self._inputs: List[str] = []
        self._outputs: List[str] = []
        self._nodes: Dict[str, NodeDef] = {}
        self._input_types = None

    def add_inputs(self, *names) -> "GraphBuilder":
        self._inputs.extend(names)
        return self

    def add_layer(self, name: str, layer: Layer, *inputs) -> "GraphBuilder":
        if name in self._nodes or name in self._inputs:
            raise ValueError(f"duplicate node name {name}")
        lyr = copy.deepcopy(layer)
        lyr.name = name
        resolve_layer_defaults(lyr, self._g)
        self._nodes[name] = NodeDef(name, lyr, list(inputs))
        return self

    def add_vertex(self, name: str, vertex: GraphVertex, *inputs) -> "GraphBuilder":
        if name in self._nodes or name in self._inputs:
            raise ValueError(f"duplicate node name {name}")
        self._nodes[name] = NodeDef(name, vertex, list(inputs))
        return self

    def set_outputs(self, *names) -> "GraphBuilder":
        self._outputs = list(names)
        return self

    def set_input_types(self, *types) -> "GraphBuilder":
        self._input_types = list(types)
        return self

    def build(self) -> ComputationGraphConfiguration:
        for n, node in self._nodes.items():
            for inp in node.inputs:
                if inp not in self._inputs and inp not in self._nodes:
                    raise ValueError(f"node '{n}' references unknown input '{inp}'")
        # Kahn topological sort
        order: List[str] = []
        placed = set(self._inputs)
        pending = dict(self._nodes)
        while pending:
            progress = False
            for name in list(pending):
                if all(i in placed for i in pending[name].inputs):
                    order.append(name)
                    placed.add(name)
                    del pending[name]
                    progress = True
            if not progress:
                raise ValueError(f"cycle in graph involving {sorted(pending)}")
        for out in self._outputs:
            if out not in self._nodes:
                raise ValueError(f"output '{out}' is not a node")
        return ComputationGraphConfiguration(
            self._g, list(self._inputs), list(self._outputs),
            self._nodes, order, self._input_types)

"""The Graph container: modules wired into a DAG, run in topological order.

Counterpart of ``bigdl_tpu/nn/graph.py``: ``Node`` (:23), ``Input``
(:66), ``Graph`` (:74-179) and ``Model`` (:327).  A module called on
nodes (``conv(input_node)``, ``join(a, b)``) returns its ``Node``
(``AbstractModule.__call__``); ``Graph(inputs, outputs)`` sorts the
nodes depth first from the outputs and registers their modules as
children ``"0"``, ``"1"``, ... in that order, so ``params()`` and
``state()`` nest by topological index as the JAX tree does (and so do
a checkpoint's keys and the flat parameter vector).  A node with
several predecessors receives the tuple of their outputs; the node at
topological index i that takes a dropout seed gets
``fold_in(rng_seed, i)``.

The forward keeps each node's output only until its last consumer has
run (the consumers are counted once, when the graph is built), so an
eager forward under ``torch.no_grad()`` holds no more activations than
the frontier of the DAG, as a compiled JAX forward would.

``DynamicGraph`` (JAX :181, cycles through ``NextIteration``) is not
ported yet and raises.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

from bigdl_tpu_torch.nn.module import AbstractModule, Container


class Node:
    """A module wired into a DAG after its predecessor nodes."""

    _counter = 0

    def __init__(self, module: AbstractModule,
                 prev_nodes: Sequence["Node"] = ()):
        Node._counter += 1
        self.id = Node._counter
        self.module = module
        self.prev_nodes: List[Node] = list(prev_nodes)

    def __repr__(self):
        return f"Node[{self.id}]({type(self.module).__name__})"


def _as_nodes(nodes) -> list:
    """Call arguments flattened one level (lists and tuples of nodes),
    ``None`` dropped."""
    flat = []
    for n in nodes:
        if isinstance(n, (list, tuple)):
            flat.extend(n)
        elif n is not None:
            flat.append(n)
    return flat


class _InputModule(AbstractModule):
    """The placeholder module of an input node: its forward is the
    graph's input."""

    def forward(self, x):
        return x


def Input(name: Optional[str] = None) -> Node:
    """A source node of a graph (JAX ``Input``)."""
    m = _InputModule()
    if name:
        m.set_name(name)
    return Node(m, [])


class Graph(Container):
    """A static DAG of modules, built from its input and output nodes."""

    def __init__(self, input, output):
        super().__init__()
        self.input_nodes: List[Node] = (
            list(input) if isinstance(input, (list, tuple)) else [input])
        self.output_nodes: List[Node] = (
            list(output) if isinstance(output, (list, tuple)) else [output])
        self._topo = self._topological_sort()
        for node in self._topo:
            self.add(node.module)
        index = {node.id: i for i, node in enumerate(self._topo)}
        self._prev = [[index[p.id] for p in node.prev_nodes]
                      for node in self._topo]
        self._inputs = [index[n.id] for n in self.input_nodes]
        self._outputs = [index[n.id] for n in self.output_nodes]
        # how many reads of each node's output a forward makes; the
        # graph's outputs are read once more, at the end
        self._uses = [0] * len(self._topo)
        for prev in self._prev:
            for j in prev:
                self._uses[j] += 1
        for j in self._outputs:
            self._uses[j] += 1

    def _topological_sort(self) -> List[Node]:
        """Depth first from the outputs (JAX :98-120); an input no output
        depends on goes first."""
        visited, order, on_stack = set(), [], set()

        def visit(node: Node):
            if node.id in visited:
                return
            if node.id in on_stack:
                raise ValueError("Graph contains a cycle")
            on_stack.add(node.id)
            for p in node.prev_nodes:
                visit(p)
            on_stack.discard(node.id)
            visited.add(node.id)
            order.append(node)

        for out in self.output_nodes:
            visit(out)
        for inp in self.input_nodes:
            if inp.id not in visited:
                order.insert(0, inp)
                visited.add(inp.id)
        return order

    def topo_order(self) -> List[Node]:
        """The nodes in execution order (the Caffe exporter's order)."""
        return list(self._topo)

    def get_config(self):
        return {}

    def _as_input_list(self, input) -> list:
        if len(self.input_nodes) == 1 and not isinstance(input,
                                                         (tuple, list)):
            inputs = [input]
        else:
            inputs = list(input)
        if len(inputs) != len(self.input_nodes):
            raise ValueError(f"Graph expects {len(self.input_nodes)} "
                             f"inputs, got {len(inputs)}")
        return inputs

    def forward(self, input, rng_seed: Optional[int] = None):
        inputs = dict(zip(self._inputs, self._as_input_list(input)))
        values = {}
        left = list(self._uses)
        for i, (node, prev) in enumerate(zip(self._topo, self._prev)):
            if i in inputs:
                x = inputs[i]
            elif len(prev) == 1:
                x = values[prev[0]]
            else:
                x = tuple(values[j] for j in prev)
            for j in prev:
                left[j] -= 1
                if left[j] == 0:
                    del values[j]
            y = self._call_child(i, node.module, x, rng_seed)
            if left[i] > 0:
                values[i] = y
        outs = tuple(values[j] for j in self._outputs)
        return outs[0] if len(outs) == 1 else outs

    def extra_repr(self):
        return f"{len(self._topo)} nodes"


class DynamicGraph(Graph):
    """JAX ``DynamicGraph`` (control flow and cycles): not ported yet."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "DynamicGraph is not ported yet (ROADMAP.md queue 1 item 12)")


def Model(input, output) -> Graph:
    """The Python-BigDL spelling of ``Graph(input, output)``."""
    return Graph(input, output)


__all__ = ["Node", "Input", "Graph", "DynamicGraph", "Model"]

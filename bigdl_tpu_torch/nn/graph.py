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

``DynamicGraph`` (JAX :181-322) runs control flow and cycles.  A
``NextIteration`` node carries a value between iterations (its
back-edge is declared with ``node.feedback_from(src)`` and is not in
``prev_nodes``), and a ``LoopCondition`` node's scalar says whether
to go on.  As JAX lowers the cycle to a fixed-length masked
``lax.scan``, the port runs iteration 0 and then ``max_iterations - 1``
more, each computing the whole body and keeping its feedback values
and outputs only while the loop is alive (``torch.where(alive, new,
old)``): the condition is never read on the host, and gradients flow
through the mask as they do through the scan.  The loop is do-while,
and the module state returned is iteration 0's: the buffers are put
back as iteration 0 left them.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from bigdl_tpu_torch.common import fold_in
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
        # the back-edge source of a cycle (DynamicGraph); not in
        # prev_nodes, so the topological sort does not follow it
        self.feedback_node: Optional["Node"] = None

    def feedback_from(self, src: "Node") -> "Node":
        """Declare ``src`` as this node's feedback source (the cycle's
        back-edge, TF's NextIteration input); returns self."""
        self.feedback_node = src
        return self

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

    def _run(self, inputs: dict, rng_seed: Optional[int],
             feed: Optional[dict] = None) -> dict:
        """One pass in topological order: the values still to be read
        after it (the graph's outputs, and a ``DynamicGraph``'s feedback
        sources and condition), by topological index.  A node in
        ``feed`` takes its value from there and reads nothing."""
        values = {}
        left = list(self._uses)
        for i, (node, prev) in enumerate(zip(self._topo, self._prev)):
            if feed is not None and i in feed:
                y = feed[i]
            else:
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
        return values

    def forward(self, input, rng_seed: Optional[int] = None):
        inputs = dict(zip(self._inputs, self._as_input_list(input)))
        values = self._run(inputs, rng_seed)
        outs = tuple(values[j] for j in self._outputs)
        return outs[0] if len(outs) == 1 else outs

    def extra_repr(self):
        return f"{len(self._topo)} nodes"


class DynamicGraph(Graph):
    """A graph with control flow: ``Graph``'s DAG engine for an acyclic
    one (Switch/Merge conditionals run by select semantics), and for a
    cycle the masked do-while loop of the module docstring, at most
    ``max_iterations`` iterations.  ``condition`` names the
    ``LoopCondition`` node when no output depends on it."""

    def __init__(self, input, output, max_iterations: int = 32,
                 condition: Optional[Node] = None):
        self._condition_node = condition
        super().__init__(input, output)
        self.max_iterations = max_iterations
        from bigdl_tpu_torch.nn.control_ops import (LoopCondition,
                                                    NextIteration)

        index = {node.id: i for i, node in enumerate(self._topo)}
        self._feedback = [
            (index[n.id], index[n.feedback_node.id]) for n in self._topo
            if isinstance(n.module, NextIteration)
            and n.feedback_node is not None]
        self._conds = [index[n.id] for n in self._topo
                       if isinstance(n.module, LoopCondition)]
        # each pass's feedback sources and condition are read after it
        for j in [s for _, s in self._feedback] + self._conds[:1]:
            self._uses[j] += 1

    def _topological_sort(self) -> List[Node]:
        """Graph's sort from the outputs, widened to the condition node
        and to the closure over the feedback edges (JAX :240-277): a
        feedback source runs every iteration even when no output
        depends on it within the iteration."""
        visited, order, on_stack = set(), [], set()

        def visit(node: Node):
            if node.id in visited:
                return
            if node.id in on_stack:
                raise ValueError(
                    "DynamicGraph: within-iteration cycle — feedback "
                    "edges must go through NextIteration.feedback_from()")
            on_stack.add(node.id)
            for p in node.prev_nodes:
                visit(p)
            on_stack.discard(node.id)
            visited.add(node.id)
            order.append(node)

        for out in self.output_nodes:
            visit(out)
        if self._condition_node is not None:
            visit(self._condition_node)
        changed = True
        while changed:
            changed = False
            for node in list(order):
                fb = node.feedback_node
                if fb is not None and fb.id not in visited:
                    visit(fb)
                    changed = True
        for inp in self.input_nodes:
            if inp.id not in visited:
                order.insert(0, inp)
                visited.add(inp.id)
        return order

    def get_config(self):
        return {"max_iterations": self.max_iterations}

    def forward(self, input, rng_seed: Optional[int] = None):
        if not self._feedback:
            return super().forward(input, rng_seed)
        from bigdl_tpu_torch.nn.control_ops import (_as_bool, buffers_of,
                                                    restore_buffers)

        inputs = dict(zip(self._inputs, self._as_input_list(input)))

        def one_iter(feed, it):
            seed = None if rng_seed is None else fold_in(rng_seed, it)
            values = self._run(inputs, seed, feed)
            new_feed = {d: values[s] for d, s in self._feedback}
            outs = tuple(values[j] for j in self._outputs)
            cond = (_as_bool(values[self._conds[0]]).reshape(())
                    if self._conds else None)
            return new_feed, outs, cond

        feed, outs, alive = one_iter(None, 0)
        kept = buffers_of(self)        # iteration 0's state is returned
        for it in range(1, self.max_iterations):
            new_feed, new_outs, cond = one_iter(feed, it)
            if alive is None:          # no condition: every pass counts
                feed, outs = new_feed, new_outs
                continue

            def keep(new, old, a=alive):
                return _map_pair(lambda x, y: torch.where(
                    a.to(x.device), x, y), new, old)

            feed = {k: keep(new_feed[k], feed[k]) for k in feed}
            outs = keep(new_outs, outs)
            alive = torch.logical_and(alive, cond.to(alive.device))
        restore_buffers(kept)
        return outs[0] if len(outs) == 1 else outs

    def extra_repr(self):
        return (f"{len(self._topo)} nodes, {len(self._feedback)} "
                f"back-edges, max_iterations={self.max_iterations}")


def _map_pair(fn, a, b):
    """``fn`` over the tensor leaves of two trees of one structure."""
    if isinstance(a, (tuple, list)):
        return type(a)(_map_pair(fn, x, y) for x, y in zip(a, b))
    return fn(a, b)


def Model(input, output) -> Graph:
    """The Python-BigDL spelling of ``Graph(input, output)``."""
    return Graph(input, output)


__all__ = ["Node", "Input", "Graph", "DynamicGraph", "Model"]

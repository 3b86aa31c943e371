"""Flowgraph DAG and its step function (port of ``grbaz_tpu/core/graph.py``).

The whole DAG becomes one step

    step : (states, params, {in_port: Stream}) -> (states', {out_port: Stream})

that runs the blocks in topological order. PyTorch runs eagerly, so
``compile`` only fixes the order and returns a plain callable.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterable, List, Tuple

from grbaz_tpu_torch.core.block import Block
from grbaz_tpu_torch.core.stream import Stream


class Flowgraph:
    """A DAG of :class:`Block` nodes with named external ports."""

    def __init__(self, name: str = "flowgraph"):
        self.name = name
        self.blocks: List[Block] = []
        # (dst_block_name, dst_port) -> (src_block_name, src_port)
        self.edges: Dict[Tuple[str, int], Tuple[str, int]] = {}
        self.in_ports: Dict[str, Tuple[str, int]] = {}
        self.out_ports: Dict[str, Tuple[str, int]] = {}
        self._by_name: Dict[str, Block] = {}

    # -- construction ------------------------------------------------------
    def add(self, block: Block) -> Block:
        if block.name in self._by_name:
            raise ValueError(f"duplicate block {block.name}")
        self.blocks.append(block)
        self._by_name[block.name] = block
        return block

    @staticmethod
    def _endpoint(ep) -> Tuple[Block, int]:
        if isinstance(ep, Block):
            return ep, 0
        blk, port = ep
        return blk, int(port)

    def _ensure(self, block: Block) -> None:
        if block.name not in self._by_name:
            self.add(block)

    def connect(self, src, dst) -> None:
        """connect(src_block[, port], dst_block[, port])."""
        sb, sp = self._endpoint(src)
        db, dp = self._endpoint(dst)
        self._ensure(sb)
        self._ensure(db)
        key = (db.name, dp)
        if key in self.edges:
            raise ValueError(f"input {key} already connected")
        self.edges[key] = (sb.name, sp)

    def chain(self, *blocks) -> Block:
        """Connect blocks in series (port 0 -> port 0); returns the last."""
        for a, b in zip(blocks, blocks[1:]):
            self.connect(a, b)
        return blocks[-1]

    def input(self, name: str, dst) -> None:
        db, dp = self._endpoint(dst)
        self._ensure(db)
        self.in_ports[name] = (db.name, dp)

    def output(self, name: str, src) -> None:
        sb, sp = self._endpoint(src)
        self._ensure(sb)
        self.out_ports[name] = (sb.name, sp)

    # -- compilation -------------------------------------------------------
    def _topo_order(self) -> List[Block]:
        deps: Dict[str, set] = {b.name: set() for b in self.blocks}
        for (dst, _dp), (src, _sp) in self.edges.items():
            deps[dst].add(src)
        order, ready = [], [b for b in self.blocks if not deps[b.name]]
        placed = set()
        while ready:
            b = ready.pop(0)
            order.append(b)
            placed.add(b.name)
            for c in self.blocks:
                if c.name not in placed and c not in ready \
                        and deps[c.name] <= placed:
                    ready.append(c)
        if len(order) != len(self.blocks):
            cyc = [b.name for b in self.blocks if b.name not in placed]
            raise ValueError(f"flowgraph has a cycle involving {cyc}")
        return order

    def init_states(self) -> Dict[str, Any]:
        return {b.name: b.init_state() for b in self.blocks}

    def init_params(self) -> Dict[str, Any]:
        return {b.name: b.init_params() for b in self.blocks}

    def build_step(self) -> Callable:
        """Build the step function for this graph."""
        order = self._topo_order()
        edges = dict(self.edges)
        in_ports = dict(self.in_ports)
        out_ports = dict(self.out_ports)

        def step(states: Dict[str, Any], params: Dict[str, Any],
                 ext_in: Dict[str, Stream]):
            produced: Dict[Tuple[str, int], Stream] = {}
            port_feed = {(bname, bport): ext_in[pname]
                         for pname, (bname, bport) in in_ports.items()}
            new_states = dict(states)
            for blk in order:
                ins = []
                for p in range(blk.n_in):
                    key = (blk.name, p)
                    if key in port_feed:
                        ins.append(port_feed[key])
                    elif key in edges:
                        ins.append(produced[edges[key]])
                    else:
                        raise ValueError(f"unconnected input {key}")
                st, outs = blk.apply(states[blk.name], params[blk.name], *ins)
                new_states[blk.name] = st
                for p, o in enumerate(outs):
                    produced[(blk.name, p)] = o
            ext_out = {pname: produced[(bname, bport)]
                       for pname, (bname, bport) in out_ports.items()}
            return new_states, ext_out

        return step

    def compile(self) -> "CompiledFlowgraph":
        return CompiledFlowgraph(self, self.build_step())


class CompiledFlowgraph:
    """A flowgraph with its step function fixed."""

    def __init__(self, graph: Flowgraph, step_fn: Callable):
        self.graph = graph
        self.step = step_fn

    def run_stream(self, ext_in_iter: Iterable[Dict[str, Stream]],
                   params: Dict[str, Any] | None = None,
                   states: Dict[str, Any] | None = None):
        """Generator: run the graph over an iterator of input blocks,
        yielding ``(ext_out, states)`` per step. The caller may mutate
        ``params`` between iterations (the control plane)."""
        states = self.graph.init_states() if states is None else states
        params = self.graph.init_params() if params is None else params
        for ext_in in ext_in_iter:
            states, ext_out = self.step(states, params, ext_in)
            yield ext_out, states

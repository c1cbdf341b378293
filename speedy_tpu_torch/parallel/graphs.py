"""CUDA graphs of the batch step's PyTorch op chains.

A batch step launches the port's kernels 1-3 from Python and, between
them, chains of small PyTorch ops: the tension chain after kernel 1, the
parallel speed law, and the grid engine's time map and phase snap after
kernel 2. At a small batch the host's time to launch those ops, not the
card, sets the step's pace. StepGraphs holds each chain as a CUDA graph,
captured once and replayed on every later step. The kernels stay eager
launches on the caller's own tensors, so their launch counts and spans,
and the caller's input and output tensors, are what they are on the eager
path.

run(name, fn, *inputs, static=...) serves fn(*inputs) from the chain's
graph; chain(name) is run with the name bound, the run_chain= that
speed_from_tension_parallel and wsola_grid_batch take. The first call
captures the chain, after one eager run of fn on the capture stream so
that nothing is set up lazily inside the capture. Every call copies its
inputs into the graph's static inputs, unless they are those tensors
already (an earlier chain's output), replays the graph on the current
stream and returns its static outputs. The next replay overwrites them: a
caller clones what it keeps. static holds the Python values fn reads
(sizes, rates); they are fixed at capture, and another value raises. The
graphs of one StepGraphs share one memory pool, so they are replayed once
each a step, in the order they were captured, on one stream. Each graph
holds the constants it read through held.upload_once, whose LRU may drop
them. No chain is captured while a profiler records: run() then calls fn.

trace.GRAPHS counts each capture and each replay by chain.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, List, NamedTuple, Tuple

import torch

from .. import held, trace


class _Chain(NamedTuple):
    graph: "torch.cuda.CUDAGraph"
    static: tuple                      # the Python values fn read at capture
    inputs: Tuple[torch.Tensor, ...]   # the graph's static inputs
    outputs: object                    # what fn returned under capture
    held: List[torch.Tensor]           # the constants fn read (held.upload_once)


def _tensors(outputs) -> tuple:
    return outputs if isinstance(outputs, tuple) else (outputs,)


def _count(key: str) -> None:
    trace.GRAPHS[key] = trace.GRAPHS.get(key, 0) + 1


class StepGraphs:
    """The graphs of one step's chains on one CUDA device."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.pool = torch.cuda.graph_pool_handle()
        self.stream = torch.cuda.Stream(self.device)
        self.chains: Dict[str, _Chain] = {}

    def chain(self, name: str) -> Callable:
        """run with the chain's name bound: run_chain(fn, *inputs, static=...)."""
        return functools.partial(self.run, name)

    def run(self, name: str, fn: Callable, *inputs: torch.Tensor, static: tuple = ()):
        """fn(*inputs) by the chain `name`'s graph, captured on the first
        call; returns the graph's static outputs."""
        chain = self.chains.get(name)
        if chain is None:
            if torch.autograd._profiler_enabled():
                return fn(*inputs)
            chain = self.chains[name] = self._capture(name, fn, inputs, static)
        elif chain.static != static:
            raise ValueError(f"chain {name!r} was captured with {chain.static}, not {static}")
        for dst, src in zip(chain.inputs, inputs):
            if src is not dst:
                dst.copy_(src)
        chain.graph.replay()
        _count(name + ":replay")
        return chain.outputs

    def _owns(self, t: torch.Tensor) -> bool:
        return any(t is o for c in self.chains.values() for o in _tensors(c.outputs))

    def _capture(self, name: str, fn: Callable, inputs, static: tuple) -> _Chain:
        ins = tuple(x if self._owns(x) else x.clone() for x in inputs)
        graph = torch.cuda.CUDAGraph()
        self.stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.device(self.device), held.held_reads() as reads:
            with torch.cuda.stream(self.stream):
                fn(*ins)
            with torch.cuda.graph(graph, pool=self.pool, stream=self.stream,
                                  capture_error_mode="thread_local"):
                outputs = fn(*ins)
        _count(name + ":capture")
        return _Chain(graph, static, ins, outputs, reads)

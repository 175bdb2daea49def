"""One decode step replayed as a CUDA graph: the port's counterpart of the
reference's ``jax.jit`` around a fixed-shape step function (the serve step
of ``src/repro/serving/engine.py:make_serve_step_fn``, jitted with the
cache donated, and the decode step that ``make_generate_fn`` scans).

A :class:`StepGraph` wraps a step ``fn()`` that reads and writes only
tensors of fixed storage (the cache, and static input buffers that the
caller fills before each call) and returns its outputs. Its first call
runs ``fn`` op by op on a side stream. That warm-up builds the kernels and
the libraries' handles, and it is the first step, effects and kernel
launches included. Then ``fn`` is captured into a CUDA graph. Every later
call checks that the fixed tensors kept their storage, replays the graph
and returns the captured outputs. They are static: the next call
overwrites them.

The kernels' launch counters count launches only (``kernels.count_launch``):
the capture adds nothing to them and a replay does not call the wrappers.
``replays`` counts the graph's launches.

A :class:`DecodeState` holds one step shape's fixed storage (its cache and
input buffers) with its step, and runs the step op by op or as a
``StepGraph``: the engine's decode and verify steps and the draft model's
proposal step each keep one.

There is no fallback. On a CUDA device a failed capture or replay raises,
and no CPU path reaches the capture.
"""

from __future__ import annotations

import contextlib
import gc
from typing import Callable, Optional, Sequence

import torch

from repro_torch.models.kv_cache import tree_leaves


@contextlib.contextmanager
def capture(graph):
    """``torch.cuda.graph(graph)`` with Python's cyclic garbage collector
    held off until the capture ends. A collection inside the capture can
    free a dead reference cycle that holds an earlier ``CUDAGraph`` (an
    engine whose method was replaced by a closure over it, say); its
    destructor destroys the graph, a call the capture forbids, which
    invalidates the capture, and the next launch reports it (cuBLAS:
    EXECUTION_FAILED)."""
    enabled = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.graph(graph):
            yield
    finally:
        if enabled:
            gc.enable()


class StepGraph:
    """``fn`` captured once as a CUDA graph (after one op-by-op warm-up
    step), then replayed on every call. ``fixed``: the tensors ``fn`` reads
    and writes in place, whose storage must not move."""

    def __init__(self, fn: Callable, fixed: Sequence[torch.Tensor]):
        self.fn = fn
        self.fixed = list(fixed)
        self.ptrs = [t.data_ptr() for t in self.fixed]
        self.graph = None
        self.out = None
        self.replays = 0

    def __call__(self):
        if self.graph is None:
            return self._warm_up_and_capture()
        if [t.data_ptr() for t in self.fixed] != self.ptrs:
            raise RuntimeError("a tensor of the captured step moved since its capture")
        self.graph.replay()
        self.replays += 1
        return self.out

    def _warm_up_and_capture(self):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            first = self.fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with capture(graph):
            self.out = self.fn()
        self.graph = graph
        return first


class DecodeState:
    """The fixed storage of one step shape and its step: ``cache``, the
    input ``buffers`` the step reads, ``decode()`` -> the step's logits over
    them, and ``post(logits, generators)``: sampling or verification (and
    for a verify round the rollback) and the step's outputs. A sampler that
    draws no random numbers (``draws`` False) runs ``post`` inside the step
    (``body``); one that draws runs it after the step with the caller's
    generators. ``run`` calls the step op by op, or replays it as a CUDA
    graph (captured at the first graphed run). ``model``: the Model whose
    step this is; the engine reads its softmax backend's ``capturable``
    (a backend that reads the device back on the host, the functional AP
    simulator, runs op by op and is never captured)."""

    def __init__(self, cache, buffers, decode: Callable, post: Callable, draws: bool,
                 model=None):
        self.cache = cache
        self.model = model
        # the int32 leaves' starting values (block tables, ring positions):
        # what a reset restores, the rest is zeroed
        self._ints = [(leaf, leaf.clone()) for leaf in tree_leaves(cache)
                      if leaf.dtype == torch.int32]
        self.buffers = list(buffers)
        self.post = post
        self.draws = draws
        self.body = decode if draws else (lambda: post(decode(), None))
        self.graph: Optional[StepGraph] = None

    def run(self, graphed: bool, generators=None):
        if not graphed:
            out = self.body()
        else:
            if self.graph is None:
                self.graph = StepGraph(self.body, tree_leaves(self.cache) + self.buffers)
            out = self.graph()
        return self.post(out, generators) if self.draws else out

    def reset_cache(self) -> None:
        """Zeros, and the int32 leaves the state was built with: what
        ``*_cache_zeros`` gives (a sentinel table, ring positions -1), or
        the identity table of ``kv_cache.contiguous_as_paged``."""
        for leaf in tree_leaves(self.cache):
            if leaf.dtype != torch.int32:
                leaf.zero_()
        for leaf, start in self._ints:
            leaf.copy_(start)

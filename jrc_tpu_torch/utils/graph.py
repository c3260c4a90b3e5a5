"""The port's counterpart of ``jax.jit``: a function of tensors run on a CUDA
device as one captured ``torch.cuda.CUDAGraph``, replayed once a call.

``jit(fn)`` returns a callable. Its inputs are the tensors found in the
arguments, at the top level or nested in tuples, NamedTuples, lists and
dicts (a ``JRCState`` carried from call to call is one input tree, as a
pytree is to ``jax.jit``). Where they lie on a CUDA device, the first call
with a new input signature (the tree's structure, each tensor leaf's shape,
dtype and device, and the value of every other leaf) runs ``fn`` once on a
side stream, the warm-up that the ``torch.cuda.graphs`` documentation
prescribes: it builds the kernel library, sets the kernels' one-time
attributes, makes PyTorch's own plans and runs each collective once, at the
very shapes that are then captured. It then captures one call into a graph
with a memory pool of its own, reading a static copy of each tensor leaf
(with the leaf's strides, which are part of the signature too: a strided
view is read by the same kernels as in the eager call).
Every call, the first included, copies its tensors into those buffers on the
current stream, replays the graph and returns fresh clones of the outputs,
so a result the caller keeps is never overwritten by a later replay. Tensors
that ``fn`` reaches otherwise (a closure, a ``functools.partial``: constant
tables) are captured by address and must live as long as the callable.

Random draws: a ``torch.Generator`` that ``fn`` draws from is named in
``jit(fn, generators=...)`` and registered with every graph
(``CUDAGraph.register_generator_state``). Its state is saved before the
warm-up and restored before the capture, which does not advance it, so the
first replay draws what the first eager call would; each replay advances it
by one call's draws, as an eager call does.

A replay runs the kernels of the eager call in the same order, so its
outputs are the same bits. A host sync inside ``fn`` fails the capture (the
capture mode "thread_local": any unsafe call of this thread fails it, while
a collective library's own watchdog thread may still poll its events). A
capture or replay error raises ``RuntimeError`` naming the function; nothing
runs eagerly in its place. On CPU tensors ``fn`` runs as it is: there is no
graph on a CPU. Inside ``with eager():`` every captured function runs ``fn``
as it is too: the eager twin that comparisons and profiles hold a captured
site against.

Counters: every call is a ``graph.replay`` span of ``utils.profiling`` on
the host (on CPU tensors, or under ``eager()``, the call of ``fn`` as it
is); ``replays`` and ``captures`` count the graphs' replays and captures;
``timings`` keeps each capture's warm-up, capture and instantiation, and
each capture is a ``graph.capture`` span. A capture after a signature's
first call would be the recompile no caller sees: ``captures`` stays at the
number of signatures. The device time of each replay of the graph (its
input copies and output clones left out) is timed with a pair of CUDA
events (``profiling.DeviceClock``: one replay in eight, no synchronize),
filed under the entry point whose stages the capture stamped.
"""
from __future__ import annotations

import contextlib
import time
from typing import Any, Callable, NamedTuple

import torch

from jrc_tpu_torch.utils import profiling

_eager_depth = 0


def map_tensors(fn: Callable, tree):
    """``tree`` (a tensor, or a tuple, NamedTuple, list or dict of them, nested)
    with ``fn`` applied to each tensor; other leaves are kept."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_tensors(fn, x) for x in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(map_tensors(fn, x) for x in tree)
    if isinstance(tree, dict):
        return {k: map_tensors(fn, v) for k, v in tree.items()}
    return tree


def structure(tree, leaves: list) -> tuple:
    """The hashable structure of ``tree``: its containers' types and keys, a
    marker for each tensor (appended to ``leaves`` in ``map_tensors``'s order)
    and the value of every other leaf, which a graph fixes at capture."""
    if isinstance(tree, torch.Tensor):
        leaves.append(tree)
        return (torch.Tensor,)
    if isinstance(tree, (tuple, list)):
        return (type(tree), tuple(structure(x, leaves) for x in tree))
    if isinstance(tree, dict):
        return (dict, tuple((k, structure(v, leaves)) for k, v in tree.items()))
    return (type(tree), tree)


def signature(args: tuple, kwargs: dict) -> tuple[tuple, list]:
    """(key, tensor leaves) of a call: the key is the structure of ``(args,
    kwargs)`` and each leaf's shape, strides, dtype and device."""
    leaves: list[torch.Tensor] = []
    tree = structure((args, kwargs), leaves)
    return (tree, tuple((tuple(t.shape), t.stride(), t.dtype, t.device) for t in leaves)), leaves


class Timing(NamedTuple):
    warmup_ms: float  # the warm-up call, host clock to a synchronize
    capture_ms: float  # the captured call (nothing runs on the card)
    instantiate_ms: float  # the executable graph made from the capture


class _Captured(NamedTuple):
    graph: torch.cuda.CUDAGraph
    inputs: list  # the static copies of the tensor leaves, in tree order
    outputs: Any  # the graph's own outputs, overwritten by each replay
    clock: profiling.DeviceClock  # each replay's device time


class CapturedFunction:
    """``fn`` captured once per input signature and replayed (see the module)."""

    def __init__(self, fn: Callable, name: str | None = None,
                 generators: tuple[torch.Generator, ...] = ()):
        self.fn = fn
        self.name = name or _name(fn)
        self.generators = tuple(generators)
        self._graphs: dict[tuple, _Captured] = {}
        self.timings: dict[tuple, Timing] = {}  # each signature's warm-up, capture, instantiation
        self._calls = 0  # every call: the index of its spans
        self.replays = 0  # the calls that replayed a graph
        self.captures = 0  # graphs captured

    def __call__(self, *args, **kwargs):
        key, leaves = signature(args, kwargs)
        devices = {t.device for t in leaves}
        if len(devices) > 1:
            raise ValueError(f"{self.name}: tensor arguments on {sorted(map(str, devices))}; "
                             "a captured function takes them on one device")
        k = self._calls
        self._calls += 1
        if not devices or next(iter(devices)).type != "cuda" or _eager_depth:
            with profiling.span("graph.replay", k):
                return self.fn(*args, **kwargs)
        captured = self._graphs.get(key)
        if captured is None:
            with profiling.span("graph.capture", k):
                captured = self._graphs[key] = self._capture(key, args, kwargs, leaves)
        with profiling.span("graph.replay", k):
            for buf, t in zip(captured.inputs, leaves):
                buf.copy_(t)
            timed = captured.clock.start()
            try:
                captured.graph.replay()
            except RuntimeError as e:
                raise RuntimeError(f"{self.name}: CUDA graph replay failed: {e}") from e
            captured.clock.stop(timed, k)
            out = map_tensors(torch.clone, captured.outputs)
        self.replays += 1
        return out

    def _capture(self, key: tuple, args: tuple, kwargs: dict, leaves: list) -> _Captured:
        with profiling.entries_stamped() as entries:
            captured = self._capture_graph(key, args, kwargs, leaves)
        self.captures += 1
        # named after the one entry point whose stages the call stamps, else after the function
        clock = profiling.DeviceClock(entries[0] if len(entries) == 1 else self.name)
        return captured._replace(clock=clock)

    def _capture_graph(self, key: tuple, args: tuple, kwargs: dict, leaves: list) -> _Captured:
        static = [_static_like(t) for t in leaves]
        for buf, t in zip(static, leaves):
            buf.copy_(t)
        it = iter(static)
        s_args, s_kwargs = map_tensors(lambda _: next(it), (args, kwargs))
        states = [g.get_state() for g in self.generators]
        with torch.cuda.device(leaves[0].device):
            current = torch.cuda.current_stream()
            side = torch.cuda.Stream()
            side.wait_stream(current)
            t0 = time.perf_counter()
            with torch.cuda.stream(side):
                self.fn(*s_args, **s_kwargs)
            current.wait_stream(side)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            for g, s in zip(self.generators, states):  # the warm-up's draws undone
                g.set_state(s)
            graph = torch.cuda.CUDAGraph(keep_graph=True)
            try:
                for g in self.generators:
                    graph.register_generator_state(g)
                with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                    outputs = self.fn(*s_args, **s_kwargs)
                t2 = time.perf_counter()
                graph.instantiate()
            except RuntimeError as e:
                raise RuntimeError(f"{self.name}: CUDA graph capture failed: {e}") from e
            t3 = time.perf_counter()
        self.timings[key] = Timing(1e3 * (t1 - t0), 1e3 * (t2 - t1), 1e3 * (t3 - t2))
        return _Captured(graph, static, outputs, None)


def _static_like(t: torch.Tensor) -> torch.Tensor:
    """An input buffer shaped and strided like ``t`` (contiguous where ``t``'s
    strides overlap, as an expanded tensor's do)."""
    if any(st == 0 for st, n in zip(t.stride(), t.shape) if n > 1):
        return torch.empty_like(t, memory_format=torch.contiguous_format)
    return torch.empty_strided(t.shape, t.stride(), dtype=t.dtype, device=t.device)


def _name(fn) -> str:
    inner = getattr(fn, "func", fn)  # a functools.partial names its function
    return getattr(inner, "__qualname__", type(inner).__name__)


def jit(fn: Callable, *, name: str | None = None,
        generators: tuple[torch.Generator, ...] = ()) -> CapturedFunction:
    """``fn`` run as a captured CUDA graph on CUDA tensors, as it is on CPU
    tensors; ``name`` (default: the function's) is what an error names;
    ``generators`` are the generators ``fn`` draws from."""
    return CapturedFunction(fn, name, generators)


@contextlib.contextmanager
def eager():
    """Every captured function runs ``fn`` as it is while this is open."""
    global _eager_depth
    _eager_depth += 1
    try:
        yield
    finally:
        _eager_depth -= 1

"""The port's counterpart of ``jax.jit``: a function of tensors run on a CUDA
device as one captured ``torch.cuda.CUDAGraph``, replayed once a call.

``jit(fn)`` returns a callable. Where its tensor arguments lie on a CUDA
device, the first call with a new input signature (each tensor argument's
shape, dtype and device, and the value of every other argument) runs ``fn``
once on a side stream, the warm-up that the ``torch.cuda.graphs``
documentation prescribes: it builds the kernel library, sets the kernels'
one-time attributes and makes PyTorch's own plans, at the very shapes that
are then captured. It then captures one call into a graph with a memory
pool of its own, reading static copies of the tensor arguments. Every call,
the first included, copies its tensors into those buffers on the current
stream, replays the graph and returns fresh clones of the outputs, so a
result the caller keeps is never overwritten by a later replay. Tensors
that ``fn`` reaches otherwise (a closure, a ``functools.partial``) are
captured by address and must live as long as the callable.

A replay runs the kernels of the eager call in the same order, so its
outputs are the same bits. A host sync inside ``fn`` fails the capture (the
default ``capture_error_mode``). A capture or replay error raises
``RuntimeError`` naming the function; nothing runs eagerly in its place.
On CPU tensors ``fn`` runs as it is: there is no graph on a CPU.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch


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


def _signature(value) -> tuple:
    if isinstance(value, torch.Tensor):
        return (tuple(value.shape), value.dtype, value.device)
    return (type(value), value)  # fixed in the graph: part of the signature, so hashable


class _Captured(NamedTuple):
    graph: torch.cuda.CUDAGraph
    inputs: list  # the static copies of the tensor arguments, in call order
    outputs: Any  # the graph's own outputs, overwritten by each replay


class CapturedFunction:
    """``fn`` captured once per input signature and replayed (see the module)."""

    def __init__(self, fn: Callable, name: str | None = None):
        self.fn = fn
        self.name = name or _name(fn)
        self._graphs: dict[tuple, _Captured] = {}

    def __call__(self, *args, **kwargs):
        values = [*args, *kwargs.values()]
        tensors = [v for v in values if isinstance(v, torch.Tensor)]
        devices = {t.device for t in tensors}
        if len(devices) > 1:
            raise ValueError(f"{self.name}: tensor arguments on {sorted(map(str, devices))}; "
                             "a captured function takes them on one device")
        if not devices or next(iter(devices)).type != "cuda":
            return self.fn(*args, **kwargs)
        key = (len(args), tuple(kwargs), tuple(_signature(v) for v in values))
        captured = self._graphs.get(key)
        if captured is None:
            captured = self._graphs[key] = self._capture(args, kwargs, tensors[0].device)
        for buf, t in zip(captured.inputs, tensors):
            buf.copy_(t)
        try:
            captured.graph.replay()
        except RuntimeError as e:
            raise RuntimeError(f"{self.name}: CUDA graph replay failed: {e}") from e
        return map_tensors(torch.clone, captured.outputs)

    def _capture(self, args: tuple, kwargs: dict, device: torch.device) -> _Captured:
        static = [v.clone() if isinstance(v, torch.Tensor) else v
                  for v in (*args, *kwargs.values())]
        s_args, s_kwargs = static[: len(args)], dict(zip(kwargs, static[len(args):]))
        with torch.cuda.device(device):
            current = torch.cuda.current_stream()
            side = torch.cuda.Stream()
            side.wait_stream(current)
            with torch.cuda.stream(side):
                self.fn(*s_args, **s_kwargs)
            current.wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            try:
                with torch.cuda.graph(graph):
                    outputs = self.fn(*s_args, **s_kwargs)
            except RuntimeError as e:
                raise RuntimeError(f"{self.name}: CUDA graph capture failed: {e}") from e
        return _Captured(graph, [v for v in static if isinstance(v, torch.Tensor)], outputs)


def _name(fn) -> str:
    inner = getattr(fn, "func", fn)  # a functools.partial names its function
    return getattr(inner, "__qualname__", type(inner).__name__)


def jit(fn: Callable, *, name: str | None = None) -> CapturedFunction:
    """``fn`` run as a captured CUDA graph on CUDA tensors, as it is on CPU
    tensors; ``name`` (default: the function's) is what an error names."""
    return CapturedFunction(fn, name)

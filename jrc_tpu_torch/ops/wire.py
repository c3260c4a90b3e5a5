"""The two sample formats a flat IQ stream reaches the RX kernels in.

* fc32: a complex64 ``(n,)`` tensor, as everywhere in the port;
* sc16: an int16 ``(n, 2)`` tensor of (re, im) pairs with an explicit
  float32 scale ``dq``; a sample's value is ``q.to(float32) * dq``, one
  rounded float32 product per component, as the reference's streamer forms
  it (jrc_tpu/io/stream.py:123-129).

K2 and K3 take either and dequantize inside their loads; their plain
versions call ``dequantize`` first. An integer tensor is never guessed to be
a quantized stream: it needs ``dq``, and a complex stream refuses one.
"""
from __future__ import annotations

import numpy as np
import torch


def dq_scale(full_scale: float = 1.0) -> float:
    """The float32 dequantization scale of an sc16 stream whose ±32767 stand
    for ±``full_scale``: the quotient in double, rounded once to float32."""
    return float(np.float32(float(full_scale) / 32767.0))


def is_sc16(x: torch.Tensor, dq, who: str) -> bool:
    """Whether ``x`` is an sc16 stream; raises on anything that is neither
    a complex64 (n,) stream without ``dq`` nor an int16 (n, 2) one with it."""
    if x.dtype == torch.int16:
        if x.dim() != 2 or x.shape[1] != 2:
            raise TypeError(f"{who}: an int16 stream is (n, 2) (re, im) pairs, got {tuple(x.shape)}")
        if dq is None:
            raise ValueError(f"{who}: an int16 stream needs its dequantization scale dq")
        return True
    if dq is not None:
        raise ValueError(f"{who}: dq given with a {x.dtype} stream; only an int16 (n, 2) stream "
                         "is dequantized")
    if x.dtype != torch.complex64 or x.dim() != 1:
        raise TypeError(f"{who}: complex64 (n,) or int16 (n, 2) stream expected, got {x.dtype} "
                        f"{tuple(x.shape)}")
    return False


def dequantize(q: torch.Tensor, dq: float) -> torch.Tensor:
    """int16 (n, 2) → complex64 (n,): ``q.to(float32) * dq`` per component."""
    return torch.view_as_complex(q.to(torch.float32) * float(dq))


def as_complex(x: torch.Tensor, dq, who: str) -> torch.Tensor:
    """The stream as complex64 (n,) samples: ``x`` itself on the fc32 wire,
    dequantized on the sc16 wire (what the plain versions work on)."""
    return dequantize(x, dq) if is_sc16(x, dq, who) else x

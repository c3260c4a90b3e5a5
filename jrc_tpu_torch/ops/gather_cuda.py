"""K3: batched frame-window row gather (port of jrc_tpu/ops/gather_pallas.py:61),
with the per-row CFO derotation that follows each gather of the RX path as
an optional argument.

``gather_rows`` runs ``gather_rows_plain`` for a CPU tensor and the CUDA
kernel of kernels/csrc/gather.cu for a CUDA tensor: one launch a call,
whatever the integer width of the starts, each counted in
``kernels.registry``.

The stream is complex64 (N,) or, with its scale ``dq``, int16 (N, 2) (the
sc16 wire, ``ops/wire.py``): the kernel then dequantizes each sample as it
loads it; the rows are complex64 either way.

``rot = (omega, n0)`` asks for
``out[b, k] = x[s_b + k] · exp(j · omega_b · (n0_b + k))``: ``omega`` is a
(B,) float32 tensor in rad/sample, ``n0`` a (B,) integer tensor or None
for a zero offset. The phase is formed in float32 as
``omega_b * (float(n0_b) + float(k))`` by both versions. Without ``rot``
kernel and plain version agree exactly; with it they are held within
``ROT_ATOL`` times the largest |x|: the kernel's ``cosf``/``sinf`` and the
contraction of its complex product need not give PyTorch's last bit (on
the H100 with torch 2.11 they do: the difference measured is 0).
"""
from __future__ import annotations

import torch

from jrc_tpu_torch import kernels
from jrc_tpu_torch.kernels import registry
from jrc_tpu_torch.ops import wire

# |kernel − plain| ≤ ROT_ATOL · max|x| for a rotated gather: a few float32
# ulp of the product (two roundings of cos/sin, two of the complex product)
ROT_ATOL = 4e-7

_INDEX_TYPES = (torch.int32, torch.int64)


def _check(x: torch.Tensor, width: int) -> int:
    n = x.shape[0]
    if n < width:
        raise ValueError(f"gather_rows: stream length {n} < requested width {width}")
    return n


def gather_rows_plain(x: torch.Tensor, starts: torch.Tensor, width: int, rot=None,
                      dq=None) -> torch.Tensor:
    """out[b] = x[s_b : s_b + width] for complex (N,) ``x`` (or int16 (N, 2)
    with ``dq``), starts clamped to [0, N − width] → (B, width); with
    ``rot = (omega, n0)`` each row is multiplied by
    exp(j · omega_b · (n0_b + k))."""
    x = wire.as_complex(x, dq, "gather_rows_plain")
    n = _check(x, width)
    s = starts.to(torch.int64).clamp(0, n - width)
    idx = s[:, None] + torch.arange(width, device=x.device)
    rows = x[idx]
    if rot is None:
        return rows
    omega, n0 = rot
    k = torch.arange(width, dtype=torch.float32, device=x.device)[None, :]
    if n0 is not None:
        k = n0.to(torch.float32)[:, None] + k
    phase = omega[:, None] * k
    return rows * torch.complex(torch.cos(phase), torch.sin(phase))


def gather_rows(x: torch.Tensor, starts: torch.Tensor, width: int, rot=None,
                dq=None) -> torch.Tensor:
    """Row gather of complex64 (N,) ``x`` (or int16 (N, 2) with ``dq``) at
    (B,) int32 or int64 ``starts`` → complex64 (B, width), rotated by
    ``rot = (omega, n0)`` where given."""
    if x.device.type == "cpu":
        return gather_rows_plain(x, starts, width, rot, dq)
    sc16 = wire.is_sc16(x, dq, "gather_rows")
    n = _check(x, width)
    if starts.dtype not in _INDEX_TYPES or starts.dim() != 1:
        raise TypeError(f"gather_rows: (B,) int32 or int64 starts expected, got {starts.dtype} "
                        f"{tuple(starts.shape)}")
    n_rows = starts.shape[0]
    omega, n0 = (None, None) if rot is None else rot
    if omega is not None and (omega.dtype != torch.float32 or omega.shape != (n_rows,)):
        raise TypeError(f"gather_rows: ({n_rows},) float32 omega expected, got {omega.dtype} "
                        f"{tuple(omega.shape)}")
    if n0 is not None and (n0.dtype not in _INDEX_TYPES or n0.shape != (n_rows,)):
        raise TypeError(f"gather_rows: ({n_rows},) int32 or int64 n0 expected, got {n0.dtype} "
                        f"{tuple(n0.shape)}")
    out = torch.empty((n_rows, width), dtype=torch.complex64, device=x.device)
    kernels.call("jrc_gather_rows", kernels.ptr(x.contiguous()), int(sc16),
                 float(dq) if sc16 else 0.0, kernels.ptr(starts.contiguous()),
                 int(starts.dtype == torch.int64), kernels.ptr(out), n, n_rows, width,
                 None if omega is None else kernels.ptr(omega.contiguous()),
                 None if n0 is None else kernels.ptr(n0.contiguous()),
                 0 if n0 is None else 1 + (n0.dtype == torch.int64))
    registry.count("gather_rows")
    return out

"""PyTorch/CUDA port of jrc_tpu: the RX chains (static-spec and SIG-driven),
their streaming ingest, and the JRC closed loop (TX, synthetic channel,
radar imaging, ``jrc_step``).

The JAX package ``jrc_tpu`` is the reference; this package mirrors its
layout (``ops/``, ``models/``) and its array layouts at the public
functions, using ``torch.complex64`` and ``torch.fft`` in place of the
(re, im) pair form the TPU needed. The Pallas kernels of the RX paths are
hand-written CUDA kernels for Hopper (``kernels/csrc``), each with a plain
PyTorch version beside it: a wrapper runs the plain version for a CPU
tensor and the kernel for a CUDA tensor.

Nothing here imports jax or any module of the JAX package: the port keeps
its own copy of the system configuration (``jrc_tpu_torch.config``). The
entry points (``models.streaming.StreamingRx``, ``StreamingRxDynamic``,
``io.stream.BlockStreamer``, ``models.jrc_trx.JRCTrx``) run on the CUDA
device unless the caller names another.
"""
import torch

# the reference runs its matmuls at Precision.HIGHEST (jrc_tpu/ops/cplx.py)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

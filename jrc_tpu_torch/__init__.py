"""PyTorch/CUDA port of the jrc_tpu static-spec RX chain.

The JAX package ``jrc_tpu`` is the reference; this package mirrors its
layout (``ops/``, ``models/``) and its array layouts at the public
functions, using ``torch.complex64`` and ``torch.fft`` in place of the
(re, im) pair form the TPU needed. The three Pallas kernels of the RX path
are hand-written CUDA kernels for Hopper (``kernels/csrc``), each with a
plain PyTorch version beside it: a wrapper runs the plain version for a CPU
tensor and the kernel for a CUDA tensor.

Only ``jrc_tpu.config`` (numpy-only) is reused from the JAX package; nothing
here imports jax.
"""
import torch

# the reference runs its matmuls at Precision.HIGHEST (jrc_tpu/ops/cplx.py)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

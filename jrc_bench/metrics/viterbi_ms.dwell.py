"""Device ms a dwell of the Viterbi kernel K1 (``ops/viterbi_cuda``): the
SIG field's decode and the payload's."""
from jrc_bench.trace import kernel_ms

#: the name of K1's CUDA kernel
NAMES = ("viterbi_decode_kernel",)


def read(obs):
    return None if obs.traced is None else kernel_ms(obs.traced, NAMES)

"""The detection kernel K2 (``ops/sync``, ``ops/detect_cuda``)'s share of its roofline in the traced calls, in percent: the least
time the card could take for the work the calls' inputs need
(``counts.kernel_bound_ms``: each call's flat stream read once and its autocorrelation written) over the kernel's device time."""
from jrc_bench import counts
from jrc_bench.trace import kernel_ms

#: the name of the kernel's CUDA function
NAMES = ("detect_kernel",)


def read(obs):
    if obs.traced is None or obs.work is None:
        return None
    bound = counts.kernel_bound_ms(obs.work, "detect")
    ms = kernel_ms(obs.traced, NAMES)
    if bound is None or ms is None:
        return None
    return 100.0 * bound / obs.traced.calls / ms

"""The yardstick's arithmetic: the peaks of the card and the bytes and
operations each RX kernel's work needs.

Each count is of the work the inputs need, whatever kernel does it: each
input byte read once, each output byte written once, float32 operations as
the algorithm needs them, and for the frames only the frames that are there
(``frame_work``: each frame's own windows and trellis), so a kernel that
skips empty slots cannot read above its roofline. The formulas are frozen
copies of the program's own roofline arithmetic (``chip_smoke.viterbi_bound``
and the K2 / K3 byte counts beside it); the lengths come from the frame
geometry of the plain reference (``reference/phy.py``).
"""
from __future__ import annotations

from jrc_bench.reference import phy
from jrc_bench.reference.phy import Kind

#: one NVIDIA H100 SXM at its 700 W limit, NVIDIA's data sheet (dense rates)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
SEG = 128  # samples of one detection segment (an int32 first trigger and count each)


def bound_ms(n_bytes: float, n_ops: float) -> float:
    """The least time in ms the card could take to move ``n_bytes`` once and
    do ``n_ops`` float32 operations."""
    return 1e3 * max(n_bytes / HBM_BYTES_PER_S, n_ops / FP32_OPS_PER_S)


def detect_work(n: int) -> tuple[int, int]:
    """(bytes, operations) of the detection front end over ``n`` complex64
    samples: the stream in and its autocorrelation out (8 B a sample each),
    a first trigger and a count (int32) a segment; per sample a complex
    product (6), |x|^2 (3), the two running sums (6), the normalized magnitude
    and its compare (5)."""
    return 16 * n + 8 * -(-n // SEG), 20 * n


def gather_work(rows: int, width: int) -> tuple[int, int]:
    """(bytes, operations) of a derotated row gather: complex64 rows read and
    written once, each row's start, omega and offset read (20 B)."""
    return 2 * 8 * rows * width + 20 * rows, 0


def viterbi_work(b: int, t: int) -> tuple[int, int]:
    """(bytes, operations) of a hard-decision Viterbi decode: (b, 2t) float32
    values in, (b, t) uint8 bits out; 64 states a step, each two adds, a
    compare-select, a compare of the 64-way min and a subtract."""
    return b * (8 * t + t), b * t * 64 * 5


def frame_work(spec: Kind) -> dict:
    """The work one received frame of ``spec`` needs: its two derotated
    windows (the LTF search and the frame's symbols) and the decodes of its
    SIG field (24 bits) and its payload (the frame's own trellis length),
    whatever envelope the program reads them over."""
    sync_length = phy.N_SYNC * phy.SYM
    n_sym = 2 + 1 + phy.N_LTF + spec.n_sym
    return {
        "detect": [],
        "gather": [gather_work(1, sync_length + phy.FFT - 1),
                   gather_work(1, 2 * phy.FFT + (n_sym - 2) * phy.SYM)],
        "viterbi": [viterbi_work(1, 24), viterbi_work(1, spec.n_data_bits)],
    }


def stream_work(n: int) -> dict:
    """The work of detecting frames in ``n`` samples."""
    return {"detect": [detect_work(n)], "gather": [], "viterbi": []}


#: the detector's look back before a block: the trigger chain's reach (2·(160 − 1) + 48 − 1
#: samples) in whole 128-sample segments
LEFT_HISTORY = -(-(2 * (2 * phy.SYM - 1) + 3 * phy.FFT // 4 - 1) // SEG) * SEG


def rx_stream_samples(block_len: int, n_blocks: int, max_payload: int) -> int:
    """Samples of one SIG-driven RX call's flat stream: the left history, the
    owned blocks and the halo: the window from a trigger of the largest frame
    the envelope allows (BPSK-1/2: the preamble searched, two L-LTF copies,
    SIG, MIMO-LTFs and data with their prefixes, one FFT more) and one FFT."""
    n_sym = phy.n_symbols(24, max_payload + 4)
    window = (phy.N_SYNC * phy.SYM + 2 * phy.FFT + (2 + 1 + phy.N_LTF + n_sym - 2) * phy.SYM
              + phy.FFT)
    return LEFT_HISTORY + n_blocks * block_len + window + phy.FFT


def dwell_stream_samples(spec: Kind) -> int:
    """Samples of one JRC dwell's comm burst: 5 symbols of padding in front,
    the frame, 3 symbols behind, then the 2·n_sync·sym_len zeros of the guard."""
    frame = (phy.N_SYNC + 1 + phy.N_LTF + spec.n_sym) * phy.SYM
    return frame + 8 * phy.SYM + 2 * phy.N_SYNC * phy.SYM


def merge(works) -> dict:
    """The work of several calls or frames together."""
    out = {"detect": [], "gather": [], "viterbi": []}
    for w in works:
        for k, v in w.items():
            out[k] = out[k] + v
    return out


def kernel_bound_ms(work: dict, kernel: str) -> float | None:
    """The bound in ms of ``kernel``'s share of ``work`` ("detect", "gather"
    or "viterbi"), or None where the work holds none of it."""
    parts = work.get(kernel) or []
    return sum(bound_ms(*w) for w in parts) if parts else None

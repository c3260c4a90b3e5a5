"""The issue floors of the profiling kernels P1 and P3, from their machine
code and the SM clock read on the card.

    python scripts/pieces_floor_cuda.py [--sass FILE] [--seconds S]

P3's ACS bodies are serial chains of dependent steps, one warp a frame, and
every frame is resident at once; what bounds them is the rate at which the
four schedulers of an SM issue warp instructions. P1's repeat2 moves every
row across lanes, two shuffles a lane and step, and the shuffle pipe
retires one warp shuffle a clock per SM. Their floors are

    P3: frames x steps x (warp instructions a step) / (4 x SMs x clock)
    P1: columns x steps x (warp shuffles a step) / (SMs x clock)

The script builds the kernel library, disassembles it with ``cuobjdump
-sass`` (or reads ``--sass FILE``, a saved disassembly) and counts:

- for each ACS body of P3 (``acs_pieces_kernel``), the instructions a step
  of the unrolled full stage: the span between the first and the last of
  lane 0's 32 stores of a step's words (``STS.64`` at a constant offset),
  over 31 steps, leaving out what a forward branch inside the span skips
  (the renormalization, taken once every chunk_t steps);
- for each variant of P1 (``shuffle_pieces_kernel``), the shuffles in its
  longest loop (the unrolled steps; the compiler may unroll further than
  the source); for repeat2 over the loop's float adds, one a step (the sum
  of a lane's two rows), which gives its shuffles a step.

Then it reads the SM clock (``nvidia-smi --query-gpu=clocks.sm``, sampled
every 100 ms) while P3's full body runs back to back at the profiling shape,
and prints one JSON object a line: the counts, the clock samples, and each
floor in ms at the median clock. Without ``--sass`` it needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import re
import shutil
import statistics
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

SMS, SCHEDULERS = 132, 4  # H100 SXM
P3_STEPS_A_STAGE = 32  # S in viterbi_pieces.cu
P3_VARIANTS = {0: "full", 1: "nopack", 2: "norepeat"}
P1_VARIANTS = ("baseline", "repeat2", "interleave", "concat", "halves", "roll8")

LINE = re.compile(r"^\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
BRA = re.compile(r"^(@!?U?P\w+\s+)?BRA(\.\w+)*\s+(`\(\.L_x_\d+\)|0x[0-9a-f]+)")


def functions(sass: str) -> dict[str, list[tuple[int, str]]]:
    """{mangled name: [(address, instruction)]} from cuobjdump's listing."""
    out, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function\s*:\s*(\S+)", line)
        if m:
            name = m.group(1)
            out[name] = []
            continue
        m = LINE.match(line)
        if m and name is not None:
            out[name].append((int(m.group(1), 16), m.group(2)))
    return out


def labels(sass: str) -> dict[str, dict[str, int]]:
    """{function: {label: address}} where the listing names branch targets."""
    out, name, pending = {}, None, []
    for line in sass.splitlines():
        m = re.search(r"Function\s*:\s*(\S+)", line)
        if m:
            name, pending = m.group(1), []
            out[name] = {}
            continue
        m = re.match(r"^\s*(\.L_x_\d+):", line)
        if m:
            pending.append(m.group(1))
            continue
        m = LINE.match(line)
        if m and name is not None:
            for lab in pending:
                out[name][lab] = int(m.group(1), 16)
            pending = []
    return out


def opcode(ins: str) -> str:
    return re.sub(r"^@!?U?P\w+\s+", "", ins).split()[0]


def branches(code, labs) -> list[tuple[int, int, bool]]:
    """(index, target index, conditional) of every branch with a target."""
    where = {addr: i for i, (addr, _) in enumerate(code)}
    out = []
    for i, (_, ins) in enumerate(code):
        m = BRA.match(ins)
        if not m:
            continue
        tgt = m.group(3)
        addr = labs.get(tgt.strip("`()"), None) if tgt.startswith("`") else int(tgt, 16)
        if addr in where:
            out.append((i, where[addr], bool(m.group(1))))
    return out


def p3_step_count(code, labs) -> dict:
    """Instructions a step of the unrolled stage of one ACS body."""
    # the unrolled stage: 32 stores in a row on one base register at offsets 0, 8, .., 248
    runs, run = {}, None
    for i, (_, ins) in enumerate(code):
        m = re.search(r"STS\.64 \[(R\d+)(?:\+(0x[0-9a-f]+))?\]", ins)
        if not m:
            continue
        base, off = m.group(1), int(m.group(2) or "0", 16)
        at = runs.setdefault(base, [])
        if off == 0:
            at.clear()
        if off == 8 * len(at):
            at.append(i)
            if len(at) == P3_STEPS_A_STAGE:
                run = list(at)
                break
    if run is None:
        raise RuntimeError(f"no run of {P3_STEPS_A_STAGE} stores of a step's words")
    first, last = run[0], run[-1]
    skipped = set()
    for i, j, cond in branches(code, labs):
        if first <= i < j <= last:
            skipped.update(range(i + 1, j))
    span = last - first
    steps = P3_STEPS_A_STAGE - 1
    ops = Counter(opcode(ins).split(".")[0] for k, (_, ins) in enumerate(code[first:last], first)
                  if k not in skipped)
    return {"span_instructions": span, "skipped_by_branches": len(skipped),
            "per_step": (span - len(skipped)) / steps,
            "opcodes_per_step": {op: round(n / steps, 2) for op, n in ops.most_common()}}


def p1_shuffle_count(code, labs, variant: str) -> dict:
    """The shuffles in the longest loop of one P1 variant and, for repeat2,
    its shuffles a step."""
    loops = [(j, i) for i, j, _ in branches(code, labs) if j <= i]
    if not loops:
        raise RuntimeError("no loop found")
    head, tail = max(loops, key=lambda ji: ji[1] - ji[0])
    ops = Counter(opcode(ins).split(".")[0] for _, ins in code[head:tail + 1])
    row = {"loop_instructions": tail - head + 1, "loop_shuffles": ops["SHFL"]}
    if variant == "repeat2":
        row["loop_steps"] = ops["FADD"]
        row["shuffles_per_step"] = ops["SHFL"] / ops["FADD"]
    return row


def template_args(name: str) -> list[int]:
    return [int(a) for a in re.findall(r"Li(\d+)E", name)]


def sm_clock_mhz(fn, seconds: float) -> list[float]:
    """SM clock samples (MHz) while ``fn`` runs back to back."""
    import torch

    t_end = time.perf_counter() + 0.5
    while time.perf_counter() < t_end:  # clocks up before the first sample
        fn()
        torch.cuda.synchronize()
    smi = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits",
                            "-lms", "100"], stdout=subprocess.PIPE, text=True)
    try:
        t_end = time.perf_counter() + seconds
        while time.perf_counter() < t_end:
            for _ in range(50):
                fn()
            torch.cuda.synchronize()
    finally:
        smi.terminate()
        out = smi.communicate(timeout=10)[0]
    return [float(v) for v in out.split() if v.strip()]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sass", help="a saved cuobjdump -sass listing of the kernel library")
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args()
    clock = None
    if args.sass:
        sass = Path(args.sass).read_text()
    else:
        import torch

        from jrc_tpu_torch import kernels, profiling

        if not torch.cuda.is_available():
            raise SystemExit("pieces_floor_cuda.py needs a CUDA device (or --sass FILE)")
        cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
        kernels.lib()
        sass = subprocess.run([cuobjdump, "-sass", str(kernels.library_path())],
                              capture_output=True, text=True, check=True).stdout
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              check=True).stdout.strip()
        print(json.dumps({"card": card, "torch": torch.__version__}), flush=True)
        (full,) = [c for c in profiling.cases(torch.device("cuda"))
                   if c.piece == "viterbi_pieces" and c.run.args[2:] == ("full", 32)]
        samples = sm_clock_mhz(full.run, args.seconds)
        clock = statistics.median(samples)
        print(json.dumps({"sm_clock_mhz": {"median": clock, "min": min(samples),
                                           "max": max(samples), "samples": len(samples)}}),
              flush=True)
    funcs, labs = functions(sass), labels(sass)
    shapes = [(3072, 864), (3072, 896)]  # the profiling cases: chunk_t 16/32, and 64
    for name, code in sorted(funcs.items()):
        if re.search(r"\dacs_pieces_kernel", name):  # not noacs
            row = {"kernel": "viterbi_pieces", "variant": P3_VARIANTS[template_args(name)[0]],
                   "template": template_args(name),
                   **p3_step_count(code, labs.get(name, {}))}
            if clock:
                row["floor_ms"] = {f"{b}x{t}": 1e3 * b * t * row["per_step"]
                                   / (SMS * SCHEDULERS * clock * 1e6) for b, t in shapes}
        elif "shuffle_pieces_kernel" in name:
            v = P1_VARIANTS[template_args(name)[0]]
            row = {"kernel": "shuffle_pieces", "variant": v,
                   **p1_shuffle_count(code, labs.get(name, {}), v)}
            if clock and row.get("shuffles_per_step"):
                row["shuffle_floor_ms"] = (1e3 * 3072 * 864 * row["shuffles_per_step"]
                                           / (SMS * clock * 1e6))
        else:
            continue
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Host streaming loop: native IQ ring → pinned staging → flat block RX
(port of jrc_tpu/io/stream.py:33-235).

A producer pushes IQ into the native SPSC ring (``jrc_tpu_torch.runtime``);
the consumer loop pops overlapped superblocks
``[left_hist | n_blocks·block_len | halo]`` straight into pinned host
buffers, copies them to the card on a copy stream of its own and calls
``flat_rx`` / ``flat_rx_dynamic`` on the compute stream, with
``pipeline_depth`` calls in flight before the first readback: while the
device computes superblock k, the copy engine already moves superblock k+1.
The host side is one thread, as in the reference: it pops, starts the copy
and makes the call. With ``jit=True`` (the reference's default) the call is
one CUDA graph replay (``utils.graph.jit``, the port's ``jax.jit``): the
superblock is copied into the graph's static input on the compute stream
and the graph replays every launch of the call; with ``jit=False`` the host
makes each launch itself.

Two wires: ``"fc32"`` carries complex64 (8 B a sample) and goes up as the
interleaved pairs it is; ``"sc16"`` carries int16 (re, im) pairs (4 B a
sample) through the ring and the transfer, and the RX kernels K2 and K3
dequantize them in their loads (no dequantized copy is written).

Congestion drops whole ring pushes (bounded loss) instead of blocking the
producer.

Counters: ``stats`` (``StreamStats``) counts the calls read back, the slots
they decoded, the frames found and the samples dropped, and keeps the
ring's fill at each pop; ``utils.profiling`` tracks the latest streamer's
``stats`` as entry ``"rx"``. The host steps are spans of ``utils.profiling``
(``stream.push``, ``stream.dispatch`` with ``stream.slot_wait`` and
``stream.pop`` inside it, ``stream.readback``), each with the superblock's
number.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from functools import partial
from typing import Iterator

import numpy as np
import torch

from jrc_tpu_torch import tables
from jrc_tpu_torch.config import OFDMConfig
from jrc_tpu_torch.models import streaming as block_rx
from jrc_tpu_torch.ops import sync
from jrc_tpu_torch.ops.wire import dq_scale
from jrc_tpu_torch.ops.encoder import FrameSpec
from jrc_tpu_torch.runtime import IQRing, IQRing16
from jrc_tpu_torch.utils import graph, profiling


@dataclass
class StreamStats:
    blocks: int = 0
    frames: int = 0
    crc_ok: int = 0
    dropped_samples: int = 0
    # the port's own counters, left out of == (which compares what the reference counts)
    calls: int = field(default=0, compare=False)  # calls read back
    # calls × n_blocks × max_frames: every slot runs the whole decode
    slots_decoded: int = field(default=0, compare=False)
    # samples the ring held at each of the last pops (the backlog)
    ring_fill: deque = field(default_factory=lambda: deque(maxlen=profiling.KEEP), compare=False)


class _Slot:
    """One staging buffer: the host tensor the ring pops into (pinned where
    the device is a card) with its numpy view, the device tensor it is copied
    to, and the two events that guard their reuse."""

    def __init__(self, shape, dtype, device: torch.device):
        on_card = device.type == "cuda"
        self.host = torch.empty(shape, dtype=dtype, pin_memory=on_card)
        self.host_np = self.host.numpy()
        self.dev = torch.empty(shape, dtype=dtype, device=device) if on_card else self.host
        self.copy_done = None  # recorded on the copy stream after the upload
        self.rx_done = None  # recorded on the compute stream after the call that reads dev


class BlockStreamer:
    """Pop-stage-dispatch pipeline over a ring with the flat block RX."""

    def __init__(
        self,
        cfg: OFDMConfig,
        spec: FrameSpec | None,
        *,
        block_len: int = 1 << 17,
        n_blocks: int = 1,
        max_frames: int = 64,
        max_payload: int = 256,
        estimator: str = "ls",
        soft: bool = False,
        ring_capacity: int | None = None,
        device=None,
        pipeline_depth: int = 2,
        wire: str = "fc32",
        full_scale: float = 1.0,
        jit: bool = True,
    ):
        """``spec=None`` selects the SIG-driven dynamic path: each frame's
        MCS/length/type is discovered from its SIG field (mixed traffic),
        bounded by ``max_payload``. A concrete ``spec`` runs the faster
        static-geometry path.

        One call covers ``n_blocks`` ownership blocks of ``block_len``
        samples, with ``max_frames`` slots per block. ``device=None`` is the
        CUDA device (it raises where there is none); ``device="cpu"`` runs
        the kernels' plain versions. ``pipeline_depth`` calls stay in
        flight before the first result readback.

        ``wire`` selects the ring and transfer sample format: ``"fc32"``
        (complex64, bit-exact) or ``"sc16"`` (int16 pairs, half the ring
        memory and half the host-to-device bytes, dequantized inside the
        RX kernels' loads); ``full_scale`` is the float amplitude that maps
        to int16 ±32767 (UHD convention: 1.0).

        ``jit=True`` runs each call on a card as one captured CUDA graph:
        captured at the first superblock, replayed for every later one
        (the zero superblocks of ``flush`` too), each result a fresh copy of
        the graph's outputs and equal to the eager call's bit for bit; a
        capture or replay error raises. ``jit=False`` makes every launch of
        a call from Python, the reference's ``jit=False``. On the CPU both
        run the plain versions as they are.
        """
        if block_len % sync.SEG:
            raise ValueError(f"block_len={block_len} must be a multiple of {sync.SEG}")
        if wire not in ("fc32", "sc16"):
            raise ValueError(f"wire must be 'fc32' or 'sc16', got {wire!r}")
        self._device = block_rx._entry_device(device)
        self.cfg = cfg
        self.spec = spec
        self.block_len = block_len
        self.n_blocks = n_blocks
        self.max_frames = max_frames
        self.span = block_len * n_blocks
        self.left_hist = block_rx.left_history_samples(cfg)
        common = dict(block_len=block_len, n_blocks=n_blocks, own_lo=self.left_hist,
                      max_frames=max_frames, estimator=estimator, soft=soft)
        if spec is None:
            self.halo = block_rx.frame_window_samples_dynamic(cfg, max_payload) + cfg.fft_len
            tab = tables.from_numpy_dynamic(cfg, max_payload, self._device)
            rx = partial(block_rx.flat_rx_dynamic, cfg, tab, max_payload=max_payload, **common)
        else:
            self.halo = block_rx.frame_window_samples(cfg, spec) + cfg.fft_len
            tab = tables.from_numpy(cfg, spec, self._device)
            rx = partial(block_rx.flat_rx, cfg, spec, tab, **common)
        # the tables live in the partial: a captured graph reads them by address
        self._rx = graph.jit(rx) if jit else rx
        self.wire = wire
        self.full_scale = float(full_scale)
        n_out = self.left_hist + self.span + self.halo
        self._depth = max(1, pipeline_depth)
        if wire == "sc16":
            self.ring = IQRing16(ring_capacity or 4 * self.span, full_scale=full_scale)
            self._dq = dq_scale(full_scale)
        else:
            self.ring = IQRing(ring_capacity or 4 * self.span)
            self._dq = None
        shape, dtype = ((n_out, 2), torch.int16) if wire == "sc16" else ((n_out,), torch.complex64)
        # one more buffer than calls in flight: the next superblock is popped
        # while every pending call still owns its own
        self._slots = [_Slot(shape, dtype, self._device) for _ in range(self._depth + 1)]
        self._next_slot = 0
        self._copy_stream = (torch.cuda.Stream(self._device)
                             if self._device.type == "cuda" else None)
        self._pending: deque = deque()  # (superblock number, its call's result)
        self._dispatched = 0  # superblocks dispatched
        self._flushed = False
        self.stats = StreamStats()
        profiling.track("rx", self.stats)

    @property
    def captured(self) -> graph.CapturedFunction | None:
        """The captured call with ``jit=True`` (its replays and captures), else None."""
        return self._rx if isinstance(self._rx, graph.CapturedFunction) else None

    def push(self, samples: np.ndarray) -> int:
        """Push complex64 samples (quantized on the way in on an sc16 wire)."""
        self._flushed = False
        with profiling.span("stream.push", self._dispatched):
            return self.ring.push(samples)

    def push_sc16(self, samples: np.ndarray) -> int:
        """Push already-quantized int16 (re, im) samples: the zero-convert
        path for radio sources that deliver sc16 natively. sc16 wire only."""
        if self.wire != "sc16":
            raise ValueError("push_sc16 requires wire='sc16'")
        self._flushed = False
        with profiling.span("stream.push", self._dispatched):
            return self.ring.push_sc16(samples)

    def _pop_and_dispatch(self) -> bool:
        """Pop one superblock into the next staging buffer, upload it and
        make its RX call; False while the ring holds no whole superblock."""
        k = self._dispatched
        with profiling.span("stream.dispatch", k):
            slot = self._slots[self._next_slot]
            if slot.copy_done is not None:
                with profiling.span("stream.slot_wait"):
                    slot.copy_done.synchronize()  # the buffer's last upload has left the host
            fill = self.ring.available()
            with profiling.span("stream.pop"):
                got = self.ring.pop_block(self.span, self.halo, self.left_hist, out=slot.host_np)
            if got is None:
                return False
            self.stats.ring_fill.append(fill)
            self._dispatched += 1
            self._next_slot = (self._next_slot + 1) % len(self._slots)
            if self._copy_stream is None:
                self._pending.append((k, self._rx(xp=slot.dev, dq=self._dq)))
                return True
            compute = torch.cuda.current_stream(self._device)
            with torch.cuda.stream(self._copy_stream):
                if slot.rx_done is not None:
                    self._copy_stream.wait_event(slot.rx_done)  # the call that last read slot.dev
                slot.dev.copy_(slot.host, non_blocking=True)
                slot.copy_done = torch.cuda.Event()
                slot.copy_done.record(self._copy_stream)
            compute.wait_event(slot.copy_done)
            self._pending.append((k, self._rx(xp=slot.dev, dq=self._dq)))
            slot.rx_done = torch.cuda.Event()
            slot.rx_done.record(compute)
            return True

    def _finalize(self, pending):
        k, res = pending
        # one small readback of both counts; it also closes the pipeline stage
        with profiling.span("stream.readback", k):
            n_valid, n_crc = torch.stack([res.valid.sum(), res.crc_ok.sum()]).tolist()
        slots = self.n_blocks * self.max_frames
        s = self.stats
        s.blocks += self.n_blocks
        s.frames += n_valid
        s.crc_ok += n_crc
        s.dropped_samples = self.ring.dropped()
        s.calls += 1
        s.slots_decoded += slots
        return res

    def process_available(self) -> Iterator:
        """Process every complete superblock currently buffered.

        Yields finalized results one pipeline depth behind the dispatches,
        so the ingest (ring pop and upload) of the next superblock is started
        before the current one is read back.
        """
        while self._pop_and_dispatch():
            while len(self._pending) >= self._depth:
                yield self._finalize(self._pending.popleft())
        while self._pending:
            yield self._finalize(self._pending.popleft())

    def flush(self) -> Iterator:
        """Zero-pad the tail so ALL trailing data forms final block(s).

        Drains complete superblocks FIRST: computing the pad before draining
        would miss it when more than one superblock is buffered. When the
        residual extends past one superblock's ownership span (into what
        would be its halo), a SECOND zero superblock flushes that remainder
        too. Idempotent: a repeat flush with nothing new pushed is a no-op
        (no zero-block calls)."""
        yield from self.process_available()
        if self._flushed:
            return
        avail = self.ring.available()
        if avail > 0:
            self.ring.push(np.zeros(self.span + self.halo - avail, np.complex64))
            yield from self.process_available()
            if avail > self.span:
                # the real tail reached into the padded block's halo region
                # (owned by the NEXT block): one more zero span drains it;
                # halo < span, so two blocks always suffice
                self.ring.push(np.zeros(self.span, np.complex64))
                yield from self.process_available()
        self._flushed = True

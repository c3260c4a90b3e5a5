"""UDP PDU ingress/egress (the port's own copy of jrc_tpu/io/udp.py) — parity with the reference's packet-generator
interface (``blocks_socket_pdu`` on port 52001, README.md:45-46 and the
comm-sim flowgraph): each UDP datagram is one PDU whose first byte is the
packet type (lib/stream_encoder_impl.cc:109-118)."""
from __future__ import annotations

import queue
import socket
import threading

import numpy as np

DEFAULT_PORT = 52001


class UdpPduSource:
    """Background UDP listener queueing datagrams as numpy byte payloads."""

    def __init__(self, port: int = DEFAULT_PORT, host: str = "127.0.0.1",
                 max_queue: int = 256):
        self.addr = (host, port)
        self._q: queue.Queue[np.ndarray] = queue.Queue(maxsize=max_queue)
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind(self.addr)
        self._sock.settimeout(0.2)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _loop(self):
        while not self._stop.is_set():
            try:
                data, _ = self._sock.recvfrom(65536)
            except socket.timeout:
                continue
            except OSError:
                break
            try:
                self._q.put_nowait(np.frombuffer(data, np.uint8))
            except queue.Full:
                pass  # drop, like a congested ring buffer

    def get(self, timeout: float | None = None) -> np.ndarray | None:
        try:
            return self._q.get(timeout=timeout)
        except queue.Empty:
            return None

    def close(self):
        self._stop.set()
        self._thread.join(timeout=1.0)
        self._sock.close()


class UdpPduSink:
    """Send decoded payloads back out as UDP datagrams (socket_pdu egress)."""

    def __init__(self, port: int, host: str = "127.0.0.1"):
        self.addr = (host, port)
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)

    def send(self, payload: bytes | np.ndarray):
        # bytes go out as they are (the reference's np.asarray(bytes, uint8) raises on them)
        data = (bytes(payload) if isinstance(payload, (bytes, bytearray))
                else np.asarray(payload, np.uint8).tobytes())
        self._sock.sendto(data, self.addr)

    def close(self):
        self._sock.close()

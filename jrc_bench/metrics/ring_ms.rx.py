"""Host ms a call in the ring (``io/stream.BlockStreamer``): the program's
``stream.push`` and ``stream.pop`` spans of each call, median over its
per-call ring. The inside twin of ``ingest_ms.rx``."""
from jrc_bench.drivers import program_counters as pc


def read(obs):
    return pc.host_ms("stream.push", "stream.pop")

"""Host ms a call the streamer blocked on the device: the program's
``stream.slot_wait`` (a staging buffer's last upload) and
``stream.readback`` (the call's counts) spans, median over its calls."""
from jrc_bench.drivers import program_counters as pc


def read(obs):
    return pc.host_ms("stream.slot_wait", "stream.readback")

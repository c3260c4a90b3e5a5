"""Host ms a call in the ingest layer (``runtime.IQRing`` under
``io/stream.BlockStreamer``): the benchmark's spans around the streamer's
pushes and its ring's pops over the measured window, over its calls."""


def read(obs):
    if not obs.spans or not obs.calls:
        return None
    return 1e3 * (sum(obs.spans["push"]) + sum(obs.spans["pop"])) / obs.calls

"""Device ms a call: the union of the intervals of the traced calls' device
operations, over the calls."""


def read(obs):
    if obs.traced is None or not obs.traced.events:
        return None
    return 1e3 * obs.traced.busy_s / obs.traced.calls

"""Device operations (kernels, copies, sets) a call in the traced segment:
the launches of the captured call (``utils/graph``) and the harness's
copies around it."""


def read(obs):
    if obs.traced is None or not obs.traced.events:
        return None
    return len(obs.traced.events) / obs.traced.calls

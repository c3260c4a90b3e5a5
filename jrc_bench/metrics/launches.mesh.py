"""Device operations (kernels, copies, sets) a step in the traced segment on
rank 0's card: the captured sharded step (``utils/graph``), its NCCL
kernels, and the upload, the readback and the check around it."""


def read(obs):
    if obs.traced is None or not obs.traced.events:
        return None
    return len(obs.traced.events) / obs.traced.calls

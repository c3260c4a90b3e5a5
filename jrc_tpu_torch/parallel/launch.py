"""Starting the ranks of a process group as processes of this host, for the
dry run, the scaling script, ``chip_smoke.py`` and the tests.

``run_ranks`` keeps one time limit for all of them: a rank still running
at the limit is killed and its check fails. Each rank's output goes to a
file, not a pipe, so that no rank blocks on a full pipe while a peer waits
for it.
"""
from __future__ import annotations

import contextlib
import os
import subprocess
import tempfile
import time


def run_ranks(argv_of, world: int, *, timeout: float, cwd=None,
              env_of=None) -> list[tuple[int | None, str]]:
    """Start ``world`` processes, ``argv_of(rank)`` each, in the environment
    of this one with LOCAL_RANK set to the rank and ``env_of(rank)`` (a
    dict) added where given, and wait for all of them up to ``timeout``
    seconds → each one's (exit code, output, stderr included). A process
    still running at the limit is killed, and its code is None."""
    with contextlib.ExitStack() as stack:
        files = [stack.enter_context(tempfile.TemporaryFile("w+")) for _ in range(world)]
        procs = [subprocess.Popen(argv_of(r), cwd=cwd, text=True, stdout=f,
                                  stderr=subprocess.STDOUT,
                                  env=dict(os.environ, LOCAL_RANK=str(r),
                                           **(env_of(r) if env_of else {})))
                 for r, f in enumerate(files)]
        deadline = time.monotonic() + timeout
        codes = []
        try:
            for p in procs:
                try:
                    codes.append(p.wait(timeout=max(0.0, deadline - time.monotonic())))
                except subprocess.TimeoutExpired:
                    codes.append(None)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
        outs = []
        for f in files:
            f.seek(0)
            outs.append(f.read())
    return list(zip(codes, outs))

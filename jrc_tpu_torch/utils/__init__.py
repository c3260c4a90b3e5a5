"""Host-side utilities of the port: CSV logging in the reference's file
formats, snapshots of the JRC state, the program's spans, counters and
stage clocks (``profiling``), the build cache, and ``graph.jit`` (a
function captured as a CUDA graph, the port's ``jax.jit``)."""

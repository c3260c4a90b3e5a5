"""Host-side utilities of the port: CSV logging in the reference's file
formats, snapshots of the JRC state, throughput counters and the profiler
hook."""

"""The sharded executors on torch.distributed (port of jrc_tpu/parallel/):
one process a rank, a capture sharded along time over the ranks of a
``DeviceMesh``, the frames that straddle a block boundary resolved by halos
that neighbouring ranks exchange point to point, the link totals reduced
with an all-reduce and the per-block results all-gathered.
"""

"""One rank of the sharded-executor tests (tests/test_torch_parallel.py), run
as a script in a process of its own:

    python tests/torch_mesh_ranks.py --store file:///tmp/s --world 2 --rank 0 \\
        --cases cases.npz --out rank0.npz

It joins a gloo process group on a file store, builds the three meshes,
runs every case of ``--cases`` through ``jrc_tpu_torch.parallel`` on the
CPU, and writes what it got (every rank the same all-gathered fields, and
the same stages and rows of the sharded steps' stage clock). It
imports nothing of jax, as on the machine with the card.
"""
import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    for name in ("--store", "--cases", "--out"):
        ap.add_argument(name, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--rank", type=int, required=True)
    args = ap.parse_args()
    torch.set_num_threads(1)  # the ranks share the test host's cores

    from jrc_tpu_torch.config import MCS, OFDMConfig, PacketType
    from jrc_tpu_torch.ops.encoder import FrameSpec
    from jrc_tpu_torch.parallel import batch, mesh, streaming
    from jrc_tpu_torch.utils import profiling

    mesh.init_distributed(args.store, args.world, args.rank, backend="gloo")
    try:
        cfg = OFDMConfig()
        with np.load(args.cases) as f:
            arrays = {k: f[k] for k in f}
        cases = json.loads(str(arrays.pop("cases")))
        time_mesh = mesh.time_mesh(device="cpu")
        batch_mesh = mesh.batch_mesh(device="cpu")
        grid = mesh.grid_mesh(2, args.world // 2, device="cpu")
        out = {"time_shape": np.array(time_mesh.mesh.shape),
               "grid_shape": np.array(grid.mesh.shape),
               "names": np.array(time_mesh.mesh_dim_names + batch_mesh.mesh_dim_names
                                 + grid.mesh_dim_names)}
        for i, case in enumerate(cases):
            block = streaming.local_block(time_mesh, arrays[f"cap_{i}"], device="cpu")
            if case["max_payload"]:
                res = streaming.sharded_rx_dynamic(cfg, time_mesh, block,
                                                   max_frames_per_block=case["max_frames"],
                                                   max_payload=case["max_payload"])
            else:
                spec = FrameSpec(MCS(case["mcs"]), case["payload_bytes"], PacketType.DATA)
                res = streaming.sharded_rx(cfg, spec, time_mesh, block,
                                           max_frames_per_block=case["max_frames"])
            out.update({f"{i}_{k}": v.numpy() for k, v in res._asdict().items()})
        # the sharded steps' stage clock: its stages in order and one complete row a step
        out["mesh_stages"] = np.array(list(profiling.stage_ms("mesh")))
        out["mesh_rows"] = np.array(len(profiling.stage_rows("mesh")))
        b = arrays["batch_spec"]
        spec = FrameSpec(MCS(int(b[0])), int(b[1]), PacketType.DATA)
        out["batched_rx"] = batch.batched_rx(batch_mesh, cfg, spec, arrays["captures"],
                                             max_frames=4, device="cpu").numpy()
        out["maps"] = batch.batched_range_angle_maps(batch_mesh, arrays["chans"],
                                                     device="cpu").numpy()
        np.savez(args.out, **out)
    finally:
        mesh.teardown()
    return 0


if __name__ == "__main__":
    sys.exit(main())

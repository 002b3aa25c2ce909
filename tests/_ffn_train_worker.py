"""One rank of the port's sharded FFN training step over gloo, for
tests/test_torch_ffn_train.py.  Imports torch, numpy and the port only.

Usage: python _ffn_train_worker.py <dir> <rank> <dp> <tp>

Reads <dir>/inputs.npz (the global params' arrays, x, y, the config, lr and
the step count), joins the process group through the file <dir>/rendezvous,
builds the (dp, tp) mesh on the CPU, takes this rank's shards and runs the
steps; writes <dir>/out_<rank>.npz with the loss of each step and this
rank's W1 and W2 tile shards after each step.
"""

import os
import sys

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from spgemm_tpu_torch.models import ffn  # noqa: E402
from spgemm_tpu_torch.parallel.mesh import train_mesh  # noqa: E402


def main() -> None:
    workdir, rank, dp, tp = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4])
    torch.set_num_threads(1)
    inp = np.load(os.path.join(workdir, "inputs.npz"))
    dist.init_process_group("gloo", init_method=f"file://{workdir}/rendezvous", rank=rank,
                            world_size=dp * tp)
    try:
        cfg = ffn.BlockSparseFFNConfig(*[int(v) for v in inp["cfg_ints"]],
                                       float(inp["density"]), "float32")
        mesh = train_mesh(dp, tp, device="cpu")
        params = ffn.shard_params(ffn.params_from_jax(
            {"w1": {"rows": inp["w1_rows"], "tiles": inp["w1_tiles"]},
             "w2": {"cols": inp["w2_cols"], "tiles": inp["w2_tiles"]}}, device="cpu"), mesh)
        x = ffn.shard_data(torch.from_numpy(inp["x"]), mesh)
        y = ffn.shard_data(torch.from_numpy(inp["y"]), mesh)
        step = ffn.make_sharded_train_step(mesh, cfg, lr=float(inp["lr"]),
                                           block_m=int(inp["block_m"]))
        losses, w1, w2 = [], [], []
        for _ in range(int(inp["steps"])):
            params, loss = step(params, x, y)
            losses.append(float(loss))
            w1.append(params["w1"]["tiles"].numpy())
            w2.append(params["w2"]["tiles"].numpy())
        np.savez(os.path.join(workdir, f"out_{rank}.npz"), losses=np.array(losses),
                 w1=np.stack(w1), w2=np.stack(w2), coords=np.array([mesh.dp_index,
                                                                    mesh.tp_index]))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()

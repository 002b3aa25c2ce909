"""One rank of the port's multi-process chain distribution over gloo, for
tests/test_torch_multihost.py.  Imports torch, numpy and the port only.

Usage: python _torch_multihost_worker.py <coordinator> <num_procs> <proc_id> <dir> <n_mats>
           [die|exchange|slow|stop]

Joins the group through parallel/multihost.init_from_env (the worker sets
JAX_COORDINATOR, JAX_NUM_PROCESSES and JAX_PROCESS_ID from its arguments),
builds the deterministic chain random_chain(n_mats, 4, 2, 0.5, seed 777,
"full"), runs run_distributed on the CPU, and (rank 0) writes the result to
<dir>/out; every rank dumps its spans to <dir>/trace_<rank>.json.  The chunk
budget and the heartbeat come in through the environment.

die: the LAST rank exits hard (code 17) right after joining, owing its
partial: the survivors must fail with PartnerLostError within the window.
slow: the LAST rank's loader sleeps 3 x SPGEMM_TPU_DCN_HEARTBEAT_S before
it returns: the run must still end, every rank waiting as the rank beats.
stop: the LAST rank's loader stops the process (SIGSTOP), so its heartbeat
stands still with its sockets open: the survivors must fail with
PartnerLostError within the window; the test kills it.
exchange: each rank builds a skewed partial directly (rank 0 <n_mats> tiles
at k 4, every other rank 7) and runs only the exchange, chunked (the env's
budget) and then padded (SPGEMM_TPU_DCN_CHUNK_MB=0) in one group; rank 0
saves both gathered lists to <dir>/exchange_{chunked,padded}.npz.
"""

import logging
import os
import signal
import sys
import time

import numpy as np
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from spgemm_tpu_torch.obs import trace as obs_trace  # noqa: E402
from spgemm_tpu_torch.parallel import multihost  # noqa: E402
from spgemm_tpu_torch.utils import io_text  # noqa: E402
from spgemm_tpu_torch.utils.blockcsr import BlockSparseMatrix  # noqa: E402
from spgemm_tpu_torch.utils.gen import random_chain  # noqa: E402


def skewed_partial(rank: int, big: int) -> BlockSparseMatrix:
    """Rank 0's partial holds `big` tiles, every other rank's 7 (k 4)."""
    k, side = 4, 64
    nnzb = big if rank == 0 else 7
    rng = np.random.default_rng(1000 + rank)
    idx = np.sort(rng.choice(side * side, size=nnzb, replace=False))
    coords = np.stack(np.divmod(idx, side), axis=1).astype(np.int64)
    tiles = rng.integers(0, 1 << 64, size=(nnzb, k, k), dtype=np.uint64)
    return BlockSparseMatrix(rows=side * k, cols=side * k, k=k, coords=coords, tiles=tiles)


def main() -> None:
    coordinator, num_procs, proc_id, workdir, n_mats = (
        sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], int(sys.argv[5]))
    mode = sys.argv[6] if len(sys.argv) > 6 else ""
    os.environ.update(JAX_COORDINATOR=coordinator, JAX_NUM_PROCESSES=str(num_procs),
                      JAX_PROCESS_ID=str(proc_id))
    # the ledger line and the owner line on stdout, where the test reads them
    logging.basicConfig(level=logging.INFO, stream=sys.stdout, format="%(name)s %(message)s")
    multihost.init_from_env()

    if mode == "die" and proc_id == num_procs - 1:
        # a host lost at the exchange boundary: group formed, partial owed
        print(f"proc {proc_id} dying deliberately", flush=True)
        os._exit(17)

    if mode == "exchange":
        partial = skewed_partial(proc_id, n_mats)
        chunked = multihost._allgather_partials(partial, partial.k)
        os.environ["SPGEMM_TPU_DCN_CHUNK_MB"] = "0"
        padded = multihost._allgather_partials(partial, partial.k)
        if proc_id == 0:
            for name, parts in (("chunked", chunked), ("padded", padded)):
                np.savez(os.path.join(workdir, f"exchange_{name}.npz"),
                         **{f"coords{i}": p.coords for i, p in enumerate(parts)},
                         **{f"tiles{i}": p.tiles for i, p in enumerate(parts)},
                         dims=np.array([[p.rows, p.cols] for p in parts]))
        print(f"proc {proc_id} done", flush=True)
        return

    k = 2
    mats = random_chain(n_mats, 4, k, 0.5, np.random.default_rng(777), "full")
    def loader(s, e):
        if proc_id == num_procs - 1 and mode == "slow":
            time.sleep(3 * int(os.environ["SPGEMM_TPU_DCN_HEARTBEAT_S"]))
        if proc_id == num_procs - 1 and mode == "stop":
            print(f"proc {proc_id} stopping itself", flush=True)
            os.kill(os.getpid(), signal.SIGSTOP)
        return mats[s : e + 1]

    result = multihost.run_distributed("unused", k, len(mats), loader=loader, device="cpu")
    if multihost.world()[1] == 0:
        io_text.write_matrix(os.path.join(workdir, "out"), result)
    obs_trace.dump_json(os.path.join(workdir, f"trace_{proc_id}.json"))
    print(f"proc {proc_id} done", flush=True)


if __name__ == "__main__":
    try:
        main()
    finally:
        # leave the group before the interpreter exits, as the CLI does: a
        # gloo group still standing at exit can abort the process
        # ("terminate called without an active exception")
        if dist.is_initialized():
            dist.destroy_process_group()

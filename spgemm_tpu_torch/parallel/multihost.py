"""Multi-process chain distribution: the literal `mpirun -np P` replacement
(the port's counterpart of the JAX package's `parallel/multihost.py`).

The reference distributes the chain over MPI ranks and funnels every partial
product through a serial rank-0 Recv loop in host memory (sparse_matrix_mult.
cu:460-556).  Here:

  * each process owns the same chain slice as an MPI rank
    (parallel/chainpart.partition_chain, the reference's N/P split) and
    reduces its sub-chain through chain_product on its device (kernel 1 on
    the card);
  * the partials, fetched to the host, are exchanged with
    `torch.distributed` all-gathers on gloo over host tensors, in rounds of
    at most `SPGEMM_TPU_DCN_CHUNK_MB` (default 64 MiB) per rank, so the
    transient exchange buffer is bounded at P x chunk however skewed the
    partials are.  The bound is logged before the first payload collective;
    a budget too small for one tile raises at once, and `=0` runs one padded
    round as wide as the largest partial, behind a loud warning;
  * every process then runs the same combine over the gathered partials,
    so the result is replicated and any rank can write it.

gloo, not NCCL: the exchange is of host buffers, as the JAX package's is,
and NCCL will not put two ranks on one card, where P processes share
`cuda:0`.  The wire format is the port's own: coords and tiles as int64
bit-views, 8 x (2 + k^2) bytes a tile; no bit depends on it.

Launch (per process):
    JAX_COORDINATOR=host0:1234 JAX_NUM_PROCESSES=P JAX_PROCESS_ID=r \\
        python -m spgemm_tpu_torch.cli <folder> --distributed

The three variables are the JAX package's, so one launcher drives both
packages.  JAX_COORDINATOR is rank 0's host and a free port: rank 0 serves
the rendezvous store there.

Failure contract under partner loss (the reference has none: a dead MPI
rank leaves the others blocked in MPI_Recv, sparse_matrix_mult.cu:508-552).
Liveness is kept apart from the exchange's waits, as the JAX package's
coordination-service heartbeat is.  While a rank loads and reduces its
sub-chain, a thread bumps its heartbeat counter on the group's rendezvous
store.  A rank that reaches the exchange waits there, on the store, for as
long as every missing partner's counter moves: a slow partner's sub-chain
may run any time past the others'.  A partner whose counter stands still for
`SPGEMM_TPU_DCN_HEARTBEAT_S` (default 100 s, the JAX package's window;
gloo's own default is 30 minutes) is lost, and so is rank 0 once its store
stops answering.  Only once every rank has reached the exchange do the gloo
collectives run, with the window as their timeout: a partner killed there
closes its sockets and the survivors' collective raises at once, and a
silent one times out.  Either way chain_product_multihost raises
PartnerLostError and no `./matrix` is written (the writer runs only after
the combine).  Recovery is a rerun.
"""

from __future__ import annotations

import contextlib
import datetime
import logging
import os
import threading
import time

import numpy as np
import torch
import torch.distributed as dist

from spgemm_tpu_torch.chain import _to_host, chain_product
from spgemm_tpu_torch.obs import trace as obs_trace
from spgemm_tpu_torch.parallel.chainpart import partition_chain
from spgemm_tpu_torch.utils import knobs
from spgemm_tpu_torch.utils.blockcsr import BlockSparseMatrix
from spgemm_tpu_torch.utils.timers import ENGINE

log = logging.getLogger("spgemm_tpu_torch.multihost")

# SPGEMM_TPU_DCN_HEARTBEAT_S when unset: the JAX package's window
DEFAULT_HEARTBEAT_S = 100

# gloo on torch 2.13 raises a plain RuntimeError, not DistBackendError, when
# a peer goes away: "Connection closed by peer" (killed: its sockets closed),
# "Connection reset by peer", or "Timed out waiting" once the group's timeout
# lapses on a silent one.  Only these messages count as partner loss.
_GLOO_PEER_LOSS = ("Connection closed by peer", "Connection reset by peer",
                   "Timed out waiting")

# this module's keys on the group's rendezvous store
_KEY = "spgemm_tpu_dcn"

_LOST = ("DCN partner lost during partial-product exchange (a peer host died or its "
         "heartbeat lapsed). No output was written; rerun the job.")


class PartnerLostError(RuntimeError):
    """A partner process died or fell silent mid-run."""


def _heartbeat_s() -> int:
    """The partner-loss window, seconds (SPGEMM_TPU_DCN_HEARTBEAT_S)."""
    hb = knobs.get("SPGEMM_TPU_DCN_HEARTBEAT_S")
    return DEFAULT_HEARTBEAT_S if hb is None else hb


def init_from_env() -> None:
    """Join the gloo process group from JAX_COORDINATOR / JAX_NUM_PROCESSES /
    JAX_PROCESS_ID; a no-op when the coordinator is unset (one process,
    P = 1) or a group already exists."""
    coord = os.environ.get("JAX_COORDINATOR")
    if not coord or dist.is_initialized():
        return
    dist.init_process_group(
        "gloo", init_method=f"tcp://{coord}",
        world_size=int(os.environ["JAX_NUM_PROCESSES"]),
        rank=int(os.environ["JAX_PROCESS_ID"]),
        timeout=datetime.timedelta(seconds=_heartbeat_s()))


def world() -> tuple[int, int]:
    """(P, this rank): (1, 0) without a process group."""
    if dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


# ------------------------------------------------------------- liveness --
# The store is shared by the heartbeat thread and the main thread; every
# call on it holds this lock.
_STORE_LOCK = threading.Lock()
_BEAT = {"depth": 0, "stop": None, "thread": None}
_POLL_S = 0.01  # the rendezvous's readiness poll


def _store():
    """The default group's rendezvous store (rank 0 serves it)."""
    return dist.distributed_c10d._get_default_store()


def _period(window: float) -> float:
    """The heartbeat's period, and the rendezvous's between reads of the
    missing ranks' counters: a twentieth of the window, within [0.05, 1] s."""
    return min(1.0, max(0.05, window / 20))


def _beat_loop(store, key: str, stop: threading.Event, period: float) -> None:
    while True:
        try:
            with _STORE_LOCK:
                store.add(key, 1)
        except dist.DistError:
            return  # rank 0's store is gone: the rendezvous reports it
        if stop.wait(period):
            return


@contextlib.contextmanager
def _beating():
    """This rank's heartbeat for the span of the block: a daemon thread
    bumps <_KEY>/hb/<rank> on the store every period.  Reentrant; a no-op
    without a group."""
    p, rank = world()
    if p == 1:
        yield
        return
    if _BEAT["depth"] == 0:
        stop = threading.Event()
        thread = threading.Thread(
            target=_beat_loop, args=(_store(), f"{_KEY}/hb/{rank}", stop,
                                     _period(_heartbeat_s())),
            name="dcn-heartbeat", daemon=True)
        _BEAT.update(stop=stop, thread=thread)
        thread.start()
    _BEAT["depth"] += 1
    try:
        yield
    finally:
        _BEAT["depth"] -= 1
        if _BEAT["depth"] == 0:
            _BEAT["stop"].set()
            _BEAT["thread"].join()


def _rendezvous(p: int, rank: int) -> None:
    """Wait on the store until every rank has reached this exchange, for as
    long as each missing rank's heartbeat moves; a missing rank whose
    counter stands still for the window, or a store that stops answering
    (rank 0 gone), raises PartnerLostError.  Every rank makes the same
    sequence of exchanges, so its count names this one.  Readiness is polled
    every _POLL_S, the heartbeats every period."""
    window = _heartbeat_s()
    period = _period(window)
    store = _store()
    try:
        with _STORE_LOCK:
            seq = store.add(f"{_KEY}/seq/{rank}", 1)
            store.set(f"{_KEY}/ready/{seq}/{rank}", "1")
        ready = {r: f"{_KEY}/ready/{seq}/{r}" for r in range(p) if r != rank}
        seen = dict.fromkeys(ready, (None, time.monotonic()))  # beats, when they last moved
        beats_due = 0.0
        while True:
            with _STORE_LOCK:
                if not seen or store.check([ready[r] for r in seen]):
                    return
            now = time.monotonic()
            if now >= beats_due:
                beats_due = now + period
                lost = []
                for r in list(seen):
                    with _STORE_LOCK:
                        if store.check([ready[r]]):
                            del seen[r]
                            continue
                        beats = store.add(f"{_KEY}/hb/{r}", 0)
                    if beats != seen[r][0]:
                        seen[r] = (beats, now)
                    elif now - seen[r][1] > window:
                        lost.append(r)
                if lost:
                    raise PartnerLostError(
                        f"{_LOST} Rank(s) {lost} neither reached the exchange nor beat for "
                        f"{window} s (SPGEMM_TPU_DCN_HEARTBEAT_S).")
            time.sleep(_POLL_S)
    except dist.DistError as e:
        raise PartnerLostError(f"{_LOST} The rendezvous store on rank 0 stopped "
                               "answering.") from e


def _all_gather(t: torch.Tensor, p: int) -> list[torch.Tensor]:
    """Every rank's t (equal shapes on every rank), in rank order."""
    if p == 1:
        return [t]
    got = [torch.empty_like(t) for _ in range(p)]
    dist.all_gather(got, t)
    return got


def _partner_lost(e: BaseException) -> bool:
    """Whether a collective's error is a lost partner: DistBackendError, or
    gloo's RuntimeError of a closed, reset or timed-out peer.  Anything
    else (a config error, a shape mismatch, memory) is the program's."""
    if isinstance(e, dist.DistBackendError):
        return True
    return type(e) is RuntimeError and any(s in str(e) for s in _GLOO_PEER_LOSS)


def _dcn_chunk_mb() -> float:
    """SPGEMM_TPU_DCN_CHUNK_MB: the per-rank chunk budget (MiB) of the
    partial exchange; 0 selects one padded round.  The registry validates
    it, naming the knob."""
    return knobs.get("SPGEMM_TPU_DCN_CHUNK_MB")


def _tile_rows(partial: BlockSparseMatrix, lo: int, n: int, k: int) -> np.ndarray:
    """Rows lo..lo+n of partial as (n, 2 + k^2) int64: coords, then the
    tile's bit-view."""
    buf = np.empty((n, 2 + k * k), dtype=np.int64)
    buf[:, :2] = partial.coords[lo:lo + n]
    buf[:, 2:] = partial.tiles[lo:lo + n].reshape(n, -1).view(np.int64)
    return buf


def _allgather_partials(partial: BlockSparseMatrix | None, k: int) -> list[BlockSparseMatrix]:
    """Every rank's partial (None on an idle rank) on every rank, with a
    bounded transient footprint: the rendezvous (every rank at the
    exchange, see the module's failure contract), a metadata all-gather
    (rows, cols, nnzb, the budget in bytes), then the coords and tiles in
    chunk rounds of equal width on every rank, at most SPGEMM_TPU_DCN_CHUNK_MB
    per rank.  Each round's gathered buffer is dropped after each rank's
    real tiles are copied out of it, so the peak transient is P x
    chunk_tiles x tile_bytes.  The bound is logged before the first payload
    collective; a budget that differs across ranks, or that cannot hold one
    tile, raises ValueError (a config error, on every rank).  A budget of 0
    runs one round as wide as the largest partial, behind a loud warning:
    its peak is unbounded in that partial."""
    p, rank = world()
    chunk_mb = _dcn_chunk_mb()  # validate the knob before any collective
    # the budget rides in the metadata: every rank must agree on the round
    # count or the collectives deadlock, so a per-process skew must surface
    # as a config error, not as a timeout mislabelled partner loss
    budget_bytes = int(chunk_mb * (1 << 20))
    meta = np.array(([partial.rows, partial.cols, partial.nnzb] if partial is not None
                     else [-1, -1, -1]) + [budget_bytes], dtype=np.int64)
    with _beating(), ENGINE.phase("dcn_exchange"):
        if p > 1:
            _rendezvous(p, rank)
        metas = torch.stack(_all_gather(torch.from_numpy(meta), p)).numpy()
        budgets = metas[:, 3]
        if not np.all(budgets == budget_bytes):
            raise ValueError(
                "SPGEMM_TPU_DCN_CHUNK_MB differs across ranks (budgets in bytes, by rank: "
                f"{budgets.tolist()}): every rank must set the same chunk budget -- the "
                "exchange round count is derived from it")
        max_nnzb = max(1, int(metas[:, 2].max()))
        tile_words = 2 + k * k  # int64 coord pair + the tile's bit-view
        tile_bytes = 8 * tile_words
        if chunk_mb == 0:
            log.warning(
                "dcn exchange: LEGACY PADDED path (SPGEMM_TPU_DCN_CHUNK_MB=0): peak "
                "exchange buffer %.3f MiB = P(%d) x max_nnzb(%d) x %d B -- unbounded "
                "in the largest partial; unset the knob for the chunked bounded "
                "exchange", p * max_nnzb * tile_bytes / (1 << 20), p, max_nnzb, tile_bytes)
            chunk_tiles = max_nnzb
        else:
            budget = chunk_mb * (1 << 20)
            if budget < tile_bytes:
                raise ValueError(
                    f"SPGEMM_TPU_DCN_CHUNK_MB={chunk_mb:g} cannot fit even one k={k} tile "
                    f"({tile_bytes} B including coords): raise the chunk budget to at least "
                    f"{tile_bytes / (1 << 20):.4f} MiB")
            chunk_tiles = min(max_nnzb, int(budget // tile_bytes))
        n_chunks = -(-max_nnzb // chunk_tiles)
        if chunk_mb:
            # the memory guard's ledger line, in the JAX package's words:
            # logged before the first payload collective, so an exchange that
            # dies mid-flight still shows what it was about to allocate
            log.info(
                "dcn exchange: %d ranks, max partial %d tiles -> %d chunk "
                "rounds of <=%d tiles; peak exchange buffer %.3f MiB "
                "(bound: P x SPGEMM_TPU_DCN_CHUNK_MB = %.3f MiB)",
                p, max_nnzb, n_chunks, chunk_tiles, p * chunk_tiles * tile_bytes / (1 << 20),
                p * chunk_mb)
        nnzb_local = partial.nnzb if partial is not None else 0
        pieces: list[list[np.ndarray]] = [[] for _ in range(p)]
        for c in range(n_chunks):
            lo = c * chunk_tiles
            width = min(chunk_tiles, max_nnzb - lo)
            buf = np.zeros((width, tile_words), dtype=np.int64)
            n_here = min(max(nnzb_local - lo, 0), width)
            if n_here:
                buf[:n_here] = _tile_rows(partial, lo, n_here, k)
            got = _all_gather(torch.from_numpy(buf), p)
            ENGINE.incr("dcn_chunks")
            for r in range(p):
                n_r = min(max(int(metas[r, 2]) - lo, 0), width)
                if n_r:  # rank r's real tiles of this round, copied, so the
                    # gathered buffer dies with the round and is not pinned by
                    # views until the final concatenate
                    pieces[r].append(got[r][:n_r].numpy().copy())
            del got
        log.info("dcn exchange: rank %d sent %d B in %d rounds (its partial: %d tiles of %d B)",
                 rank, max_nnzb * tile_bytes, n_chunks, nnzb_local, tile_bytes)
    partials = []
    for r in range(p):
        rows, cols, nnzb = (int(v) for v in metas[r, :3])
        if rows < 0:
            continue  # idle rank (N < P, the :612 branch)
        if not nnzb:
            partials.append(BlockSparseMatrix(rows=rows, cols=cols, k=k))
            continue
        flat = np.concatenate(pieces[r], axis=0)
        partials.append(BlockSparseMatrix(
            rows=rows, cols=cols, k=k, coords=np.ascontiguousarray(flat[:, :2]),
            tiles=np.ascontiguousarray(flat[:, 2:]).view(np.uint64).reshape(nnzb, k, k)))
    return partials


def chain_product_multihost(matrices_for_me: list | None, k: int, multiply=None,
                            **kwargs) -> BlockSparseMatrix:
    """Reduce this process's sub-chain (chain_product, on kwargs' device),
    fetch its partial to the host, exchange the partials, and run the
    reference's combine over them, replicated on every rank; a single
    partial is returned as it is.  kwargs go to both chain_product calls.
    The heartbeat runs from the sub-chain to the end of the exchange.  A
    partner lost before the exchange or in one of its collectives raises
    PartnerLostError; any other error surfaces as itself."""
    partial = None
    with _beating():
        if matrices_for_me:
            with ENGINE.phase("dcn_chain"):
                partial = _to_host(chain_product(matrices_for_me, multiply=multiply, **kwargs))
        try:
            partials = _allgather_partials(partial, k)
        except RuntimeError as e:  # DistBackendError is one; PartnerLostError passes
            if not _partner_lost(e):
                raise
            raise PartnerLostError(_LOST) from e
    log.info("gathered %d partials over DCN", len(partials))
    if len(partials) == 1:
        return partials[0]
    with ENGINE.phase("dcn_combine"):
        return chain_product(partials, multiply=multiply, **kwargs)


def run_distributed(folder: str, k: int, n: int, loader, multiply=None,
                    **kwargs) -> BlockSparseMatrix:
    """The distributed run: this rank's slice of partition_chain(n, P),
    loaded alone with loader(start, end) (the inclusive sub-chain), reduced,
    exchanged and combined, with the heartbeat on from the load.  Rank and
    P come from the process group (0 and 1 without one).  Every span
    carries rank and world tags, so `cli trace-dump --merge` stitches the
    per-rank dumps.  folder is unused (the JAX package's signature); kwargs
    go to chain_product."""
    p, r = world()
    parts = partition_chain(n, p)
    my = parts[r] if r < len(parts) else None
    log.info("process %d/%d owns chain[%s]", r, p, my)
    with _beating(), obs_trace.RECORDER.tagged(rank=r, world=p):
        mine = loader(my[0], my[1]) if my is not None else None
        return chain_product_multihost(mine, k, multiply=multiply, **kwargs)

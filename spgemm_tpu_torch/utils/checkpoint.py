"""Checkpoint and resume for chain reductions (the port's copy of the JAX
package's `utils/checkpoint.py`, with the same file format).

After each reduction pass the surviving partial products are written as one
`pass_<i>.npz` (temporary file, then an atomic rename) with the keys `n` and,
per matrix, `m<i>_meta` (rows, cols, k), `m<i>_coords` and `m<i>_tiles`: the
BlockSparseMatrix arrays, so a checkpoint round-trips losslessly and one
written by either package resumes in the other.  A restart resumes from the
newest pass that loads; a corrupt one falls back to the next-newest.

The port adds two keys: `inputs_fp`, a fingerprint of the chain's inputs
(inputs_fingerprint), and `arith`, the arithmetic of the backend that wrote
the pass (arithmetic(): `field` for mxu, `exact` for exact, hybrid and
oracle, which give the same bytes).  A resume skips a pass tagged for other
inputs or another arithmetic, so a directory reused for another chain, or
for the same chain under mxu, never hands those partials to this run.  A
pass without a key (one the JAX package wrote) is taken as before on that
key, and the JAX package's loader reads only `n` and `m<i>_*`, so either
package still resumes the other's.
"""

from __future__ import annotations

import hashlib
import logging
import os
import re

import numpy as np

from spgemm_tpu_torch.utils.blockcsr import BlockSparseMatrix

log = logging.getLogger("spgemm_tpu_torch.checkpoint")

_PASS_RE = re.compile(r"^pass_(\d+)\.npz$")


def inputs_fingerprint(matrices: list[BlockSparseMatrix]) -> str:
    """blake2b over each input's dims, coords and tiles."""
    h = hashlib.blake2b(digest_size=32)
    for m in matrices:
        h.update(repr((m.rows, m.cols, m.k, m.nnzb)).encode())
        h.update(np.ascontiguousarray(m.coords).tobytes())
        h.update(np.ascontiguousarray(m.tiles).tobytes())
    return h.hexdigest()


def arithmetic(backend: str) -> str:
    """The arithmetic a backend's passes are in: `field` (clean mod
    2^64 - 1) for mxu, `exact` (the reference's fold) for the others."""
    return "field" if backend == "mxu" else "exact"


def save_pass(ckpt_dir: str, pass_idx: int, matrices: list[BlockSparseMatrix],
              inputs_fp: str | None = None, arith: str | None = None) -> str:
    """Atomically write the partial products surviving after `pass_idx`,
    tagged with inputs_fp and arith when given."""
    os.makedirs(ckpt_dir, exist_ok=True)
    payload: dict = {"n": np.int64(len(matrices))}
    if inputs_fp is not None:
        payload["inputs_fp"] = np.array(inputs_fp)
    if arith is not None:
        payload["arith"] = np.array(arith)
    for i, m in enumerate(matrices):
        payload[f"m{i}_meta"] = np.array([m.rows, m.cols, m.k], np.int64)
        payload[f"m{i}_coords"] = m.coords
        payload[f"m{i}_tiles"] = m.tiles
    path = os.path.join(ckpt_dir, f"pass_{pass_idx}.npz")
    tmp = path + ".tmp.npz"
    with open(tmp, "wb") as f:
        np.savez_compressed(f, **payload)
    os.replace(tmp, path)
    return path


class _OtherRun(Exception):
    pass


def _load_pass(path: str, inputs_fp: str | None,
               arith: str | None) -> list[BlockSparseMatrix]:
    with np.load(path) as z:
        for key, want in (("inputs_fp", inputs_fp), ("arith", arith)):
            if want is not None and key in z.files and str(z[key]) != want:
                raise _OtherRun(f"written for other {'inputs' if key == 'inputs_fp' else 'arithmetic'}")
        n = int(z["n"])
        mats = []
        for i in range(n):
            rows, cols, k = (int(v) for v in z[f"m{i}_meta"])
            mats.append(BlockSparseMatrix(rows=rows, cols=cols, k=k,
                                          coords=z[f"m{i}_coords"], tiles=z[f"m{i}_tiles"]))
    return mats


def latest_pass(ckpt_dir: str, inputs_fp: str | None = None, arith: str | None = None
                ) -> tuple[int, list[BlockSparseMatrix]] | None:
    """The newest pass that loads, as (pass_idx, matrices), or None.

    The rename makes a write atomic, but the newest file can still be
    corrupt (a torn disk write, a half-copied directory).  Any pass that
    fails to load falls back to the next-newest with a warning: every pass
    is a whole snapshot, so an older one is a valid, earlier, restart
    point.  With inputs_fp (arith), a pass tagged with another fingerprint
    (arithmetic) is skipped the same way.  None only when no pass loads."""
    if not os.path.isdir(ckpt_dir):
        return None
    indices = sorted((int(m.group(1)) for m in map(_PASS_RE.match, os.listdir(ckpt_dir)) if m),
                     reverse=True)
    for idx in indices:
        path = os.path.join(ckpt_dir, f"pass_{idx}.npz")
        try:
            return idx, _load_pass(path, inputs_fp, arith)
        except _OtherRun as e:
            log.warning("checkpoint %s was %s; skipped", path, e)
        except Exception as e:  # noqa: BLE001 -- any unreadable pass falls back
            log.warning("checkpoint %s unreadable (%r); falling back to the "
                        "next-newest pass", path, e)
    return None

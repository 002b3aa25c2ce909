"""spgemmd on the port: the resident daemon that owns the card and keeps the
engine warm across submitted chain jobs (the port's copy of the JAX
package's `serve/`, without cross-job batching, the multi-slice pool and
the obs ops).

  protocol.py  -- the JAX daemon's wire protocol (v4, newline-delimited
                  JSON over a unix socket, optionally TCP), byte for byte.
  queue.py     -- bounded per-tenant fair queue with admission control and
                  per-job deadlines.
  placement.py -- the price book keyed by the input folder's stat signature.
  daemon.py    -- the executor on one slice, the watchdog, the journal, the
                  warm store, and `main()` (`cli serve`).
  client.py    -- client calls and the CLI's `submit`/`status`.
  smoke.py     -- end-to-end proof: `python -m spgemm_tpu_torch.serve.smoke`.

protocol, queue, placement and client import neither torch nor numpy: a
submitting process must not pay the cold torch import the daemon exists to
amortize.
"""

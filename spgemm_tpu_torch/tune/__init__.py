"""spgemm_tpu_torch.tune: the autotuner (the port's copy of the JAX package's
`tune/`).

A control loop over the knobs that move wall time and never bits: spgemmd
times one knob vector per trial leg on a structure class's representative
folder while its pool is idle (a real job preempts the leg at the next
multiply boundary), promotes a winner behind the canary gate, persists it in
the warm store's tune tier and adopts it again after a restart.  Imports
neither torch nor numpy: trial execution is the daemon's callback and
persistence an injected store.
"""

from spgemm_tpu_torch.tune.tuner import (  # noqa: F401
    TUNER,
    TrialPreempted,
    Tuner,
    enabled,
    min_win,
    run_trial_leg,
    trial_cadence_s,
    trial_vectors,
)

"""launches_per_chain (layer execute): launches of the fold kernels over
the window, per chain: kernel 1's mod and no_mod variants and the dense
fold, from the launch counters their wrappers bump where they launch.  A
batched launch serves several chains and counts once."""

COUNTERS = ("launches_numeric_round", "launches_numeric_round_no_mod", "launches_dense_fold")


def read(rec) -> float | None:
    launches = sum(rec.counters.get(name, 0) for name in COUNTERS)
    if rec.chains == 0 or launches == 0:
        return None
    return launches / rec.chains

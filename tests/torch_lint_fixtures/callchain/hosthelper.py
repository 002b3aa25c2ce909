"""Non-numeric helper module for the interprocedural FLD fixture: the
reductions live HERE (legal in this module's own scope) and taint the
numeric caller across the module boundary."""

import hostdeep


def hidden_add(out, keys, vals):
    return out.index_add_(0, keys, vals)  # the hidden reduction (legal here)


def outer(x):
    return hostdeep.inner(x)  # second hop toward hostdeep's reduction


def sized(x):
    # spgemm-lint: fld-proof(seeded: source-proved sum keeps callers untainted)
    return x.sum()

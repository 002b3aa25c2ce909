"""Seeded interprocedural FLD: the "hide the index_add_ in utils/" hole.

This file sits on a numeric-path suffix (ops/spgemm.py), so calls into
non-numeric helpers that transitively perform an unordered reduction are
call-site findings -- one hop (hosthelper.hidden_add) and two hops
(hosthelper.outer -> hostdeep.inner).  A call-site fld-proof escape and a
source-proved helper are the legal shapes.  NOT part of the package --
linted by tests/test_torch_lint.py only.
"""

import hosthelper
from hosthelper import hidden_add


def one_hop(out, keys, vals):
    return hidden_add(out, keys, vals)  # FLD: reduction one call-hop away


def two_hops(x):
    return hosthelper.outer(x)  # FLD: reduction two call-hops away


def escaped_site(out, keys, vals):
    # spgemm-lint: fld-proof(seeded: call-site escape suppresses the taint)
    return hidden_add(out, keys, vals)


def proved_at_source(x):
    return hosthelper.sized(x)  # legal: the helper proves its sum at source

"""spgemm-lint FLD fixture: ops/delta.py is in the numeric-lint scope.

The delta subsystem decides which output rows re-fold (its reachability
masks gate the numeric path), so an unordered reduction smuggled into a
delta helper must be a finding.  Never imported."""

import torch


def smuggled_dirty_total(pair_dirty):
    return torch.sum(pair_dirty)  # seeded FLD: unordered reduction

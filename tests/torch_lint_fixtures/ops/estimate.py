"""spgemm-lint FLD fixture: ops/estimate.py is in the numeric-lint scope.

The estimator's predictions steer budgets and routing on the numeric path,
and its sizing sums carry fld-proof escapes in the real module -- a
`torch.sum` smuggled into an estimator helper without one must be a
finding.  Never imported."""

import torch


def smuggled_mass_total(row_mass):
    return torch.sum(row_mass)  # seeded FLD: unordered reduction

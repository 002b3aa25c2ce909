"""spgemm-lint FLD fixture: the kernel wrappers (ops/cuda_*.py) are in the
numeric-lint scope -- each holds its kernel's plain version, the fold the
CUDA kernel must reproduce bit for bit.  Never imported."""

import torch


def fold_ref(out, keys, prods):
    out.index_add_(0, keys, prods)  # seeded FLD: atomic-order fold
    return out

"""spgemm-lint FLD fixture (torch idiom): seeded unordered reductions.

The `ops/spgemm.py` path suffix puts this file in the linter's numeric-
module scope -- fixtures exercise exactly the production path-based
scoping.  NEVER imported (tests parse it via lint_file); the code only
needs to be syntactically valid.
"""

import functools

import torch
import torch.distributed as dist


def bad_torch_sum(tiles):
    return torch.sum(tiles, dim=0)  # seeded FLD: unordered reduction


def bad_all_reduce(partial_tile):
    return dist.all_reduce(partial_tile)  # seeded FLD: collective sum


def bad_reduce_scatter(out, parts):
    return dist.reduce_scatter_tensor(out, parts)  # seeded FLD


def bad_index_add(out, keys, vals):
    return out.index_add_(0, keys, vals)  # seeded FLD: atomic-order adds


def bad_scatter_add(out, keys, vals):
    return out.scatter_add_(0, keys, vals)  # seeded FLD


def bad_scatter_reduce(out, keys, vals):
    return torch.scatter_reduce(out, 0, keys, vals, "sum")  # seeded FLD


def bad_segment_reduce(flat, lengths):
    return torch.segment_reduce(flat, "sum", lengths=lengths)  # seeded FLD


def bad_functools_reduce(tiles):
    return functools.reduce(lambda a, b: a + b, set(tiles))  # seeded FLD


def bad_method_sum(acc):
    return acc.sum(dim=-1)  # seeded FLD: method spelling


def escaped_proven_sum(tiles):
    # spgemm-lint: fld-proof(fixture: safe_exact_bound holds, sum == fold)
    return torch.sum(tiles, dim=0)  # escaped: must NOT be a finding


def legal_builtin_sum(values):
    return sum(list(values))  # builtin left fold is ordered: legal


def legal_index_copy(out, keys, vals):
    return out.index_copy_(0, keys, vals)  # a copy, no fold: legal

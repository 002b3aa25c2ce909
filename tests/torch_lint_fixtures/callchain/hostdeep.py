"""Deepest module of the interprocedural FLD fixture: the two-hop
reduction target (numeric caller -> hosthelper.outer -> inner)."""

import torch


def inner(x):
    return torch.sum(x)

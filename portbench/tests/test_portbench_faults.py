"""The comparison fails where it must: the control (the port's field-mode
path, `mxu`, in place of the exact fold) and faults planted in the timed path
underneath a run, on the CPU with the harness's look for a card skipped.
The cells run on one card, so no exchange between cards can be left out."""

import pytest
import torch
from _tiny import run


@pytest.mark.parametrize("cell", ["medium.sweep", "medium.batch4"])
def test_the_control_is_not_correct(tmp_path, monkeypatch, cell):
    result, _ = run(tmp_path, cell, monkeypatch, backend="mxu")
    assert result["correct"] is False
    assert result["checks"]["bad_tiles"]["value"] > 0


@pytest.mark.parametrize("cell", ["medium.sweep", "medium.batch4"])
def test_a_fold_that_leaves_its_state_unchanged_is_caught(tmp_path, monkeypatch, cell):
    from spgemm_tpu_torch.ops import cuda_spgemm

    def unchanged(a_slab, b_slab, pa, pb, no_mod=False):
        return torch.zeros((*pa.shape[:-1], a_slab.shape[-1], a_slab.shape[-1]),
                           dtype=torch.int64)

    monkeypatch.setattr(cuda_spgemm, "numeric_round_ref", unchanged)
    result, _ = run(tmp_path, cell, monkeypatch)
    assert result["correct"] is False
    assert result["checks"]["bad_tiles"]["value"] > 0


@pytest.mark.parametrize("cell", ["medium.sweep", "medium.batch4"])
def test_an_answer_altered_where_it_is_produced_is_caught(tmp_path, monkeypatch, cell):
    from spgemm_tpu_torch.ops import cuda_spgemm
    real = cuda_spgemm.numeric_round_ref

    def altered(*args, **kwargs):
        out = real(*args, **kwargs)
        out.view(-1)[0] ^= 1 << 40
        return out

    monkeypatch.setattr(cuda_spgemm, "numeric_round_ref", altered)
    result, _ = run(tmp_path, cell, monkeypatch)
    assert result["correct"] is False
    assert result["checks"]["bad_tiles"]["value"] > 0


def test_half_of_a_batch_left_out_is_caught(tmp_path, monkeypatch):
    from spgemm_tpu_torch import chain
    real = chain.execute_batched

    def half(p, pairs, folds=None, **kw):
        kept = real(p, pairs[:len(pairs) // 2], **({"folds": folds} if folds else {}))
        return kept + kept[:len(pairs) - len(kept)]  # the rest copied from the half run

    monkeypatch.setattr(chain, "execute_batched", half)
    result, _ = run(tmp_path, "medium.batch4", monkeypatch)
    assert result["correct"] is False
    assert result["checks"]["bad_tiles"]["value"] > 0


def test_a_request_that_raises_is_counted_and_fails_the_run(tmp_path, monkeypatch):
    from portbench import harness
    from spgemm_tpu_torch.ops import cuda_spgemm
    real_fold, real_window = cuda_spgemm.numeric_round_ref, harness.Driver.window
    in_window = []

    def broken(*args, **kwargs):
        if in_window:
            raise RuntimeError("planted")
        return real_fold(*args, **kwargs)

    def window(self, *args, **kwargs):
        in_window.append(True)
        return real_window(self, *args, **kwargs)

    monkeypatch.setattr(cuda_spgemm, "numeric_round_ref", broken)
    monkeypatch.setattr(harness.Driver, "window", window)
    result, lines = run(tmp_path, "medium.sweep", monkeypatch)
    assert result["correct"] is False
    assert result["attempted"] == 1 and result["failed"] == 1
    assert result["checks"]["failed"]["value"] == 1
    assert "check failed 1 limit 0" in lines

"""DRF fixture (the port's registries): the quiet call-site half of a
drift scenario.

This module references exactly one declared knob and emits exactly one
declared event kind.  On its own it yields ZERO findings: every DRF
sub-audit self-gates on its registry module being in the linted unit set.
tests/test_torch_lint.py builds a tmp tree placing copies of the port's
registry modules at matching suffixes next to this file, making every
OTHER registry entry unreferenced -- the drift findings then anchor at the
registry declaration lines, and the entries referenced here must NOT be
flagged.
NOT part of the package -- linted by tests/test_torch_lint.py only.
"""

from spgemm_tpu_torch.obs import events
from spgemm_tpu_torch.utils import knobs


def referenced_surface():
    cap = knobs.get("SPGEMM_TPU_PLAN_CACHE")  # keeps this knob drift-free
    events.emit("job_start", cap=cap)  # keeps this kind drift-free
    return cap

"""FPT fixture (the port's registry): failpoint-name discipline.

Seeded violations: an undeclared point name, a computed (non-literal)
name, and the same through the bare-function import spelling.  Legal
shapes alongside: declared names through both import spellings.
NOT part of the package -- linted by tests/test_torch_lint.py only.
"""

from spgemm_tpu_torch.utils import failpoints
from spgemm_tpu_torch.utils.failpoints import check as fp_check


def bad_undeclared():
    failpoints.check("made.up.point")  # FPT: undeclared failpoint name


def bad_dynamic(name):
    failpoints.check(name)  # FPT: computed failpoint name


def bad_bare_import():
    fp_check("also.made.up")  # FPT: undeclared via the bare import


def legal_declared():
    if failpoints.check("warm.load"):  # legal: declared (corrupt kind)
        return True
    fp_check("tune.trial")  # legal: declared via the bare import
    return False

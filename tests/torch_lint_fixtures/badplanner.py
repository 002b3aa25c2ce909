"""spgemm-lint BKD fixture (torch idiom): card touches inside a @host_only
helper.

Planner/worker-thread code (chain.py's plan-ahead worker and the planner it
runs) is marked with utils/backend_probe.host_only and must never call
into torch's device side: a CUDA call there serialises the planner behind
the main thread's launches, and a failing card raises where nothing fails
over.  The BKD rule scans the WHOLE decorated body, not just import time.
Never imported.
"""

import numpy as np
import torch

from spgemm_tpu_torch.utils.backend_probe import host_only


@host_only
def bad_planner_helper(join):
    torch.cuda.synchronize()  # seeded BKD: a card sync on the planner
    pa = torch.as_tensor(join).cuda()  # seeded BKD: a copy to the card
    return pa


@host_only
def good_planner_helper(coords, device):
    # the device resolved on the main thread, passed in as data: legal
    return (np.asarray(coords).shape, device)


def legal_unmarked_lazy():
    # unmarked function body: BKD stays an import-time rule here (the
    # engine touches the card lazily from the main thread by design)
    return torch.cuda.device_count()  # legal lazy touch

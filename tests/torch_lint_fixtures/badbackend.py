"""spgemm-lint BKD fixture (torch idiom): seeded module-import-time CUDA
context touches (a forked daemon, fleet or --distributed child cannot
re-initialise a context its parent made, so only utils/backend_probe may
touch the card, and only lazily).  Never imported."""

import torch
import torch.distributed as dist

_Z = torch.cuda.device_count()  # seeded BKD: runs at import

_ONES = torch.ones(8, 8).cuda()  # seeded BKD: a copy to the card at import


def bad_default(stream=torch.cuda.current_stream()):  # seeded BKD: default
    return stream                                     # evaluates at import


class Holder:
    GROUP = dist.init_process_group("gloo")  # seeded BKD: class body runs


def legal_lazy_probe():
    return torch.cuda.device_count()  # inside a function body: legal


EVENT = torch.cuda.Event  # attribute access, no call: legal
_CPU = torch.zeros(8)  # a host tensor makes no context: legal


if __name__ == "__main__":
    print(torch.cuda.device_count())  # script driver block: legal

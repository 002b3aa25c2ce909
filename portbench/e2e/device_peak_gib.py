"""device_peak_gib: the device allocator's peak over the whole run, set-up
included (torch.cuda.max_memory_allocated), read as the window closes and
before the reference runs, in GiB."""


def read(win) -> float:
    return win.peak_bytes / 2 ** 30

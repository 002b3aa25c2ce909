"""setup_s: from the process's start to the first timed request: imports,
kernels built or loaded from the checkout's cache, the leaves' structure,
the warm-up requests that plan, compile and measure every shape the window
uses."""


def read(win) -> float:
    return win.setup_s

"""chain_s: the window's seconds over the chain products it completed (a
request of J chains completes J), the window running from its start to the
end of its last request, so it takes in all the work and all the time."""


def read(win) -> float:
    return win.seconds / win.chains

"""Device: the share of the traced window in which no kernel, copy or
fill ran on the card, in %."""


def read(run, name):
    tr = run.trace
    if tr is None or tr.window is None or not tr.kernels:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s())

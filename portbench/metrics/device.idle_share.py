"""device.idle_share: the share of the traced window, in %, in which no
kernel, copy or set ran on the card (1 - the union of the trace's device
intervals over the window; layer: device)."""


def read(run):
    if run.trace is None:
        return None
    lo, hi = run.trace.window
    return 100.0 * (1.0 - run.trace.busy_seconds() / ((hi - lo) / 1e6))

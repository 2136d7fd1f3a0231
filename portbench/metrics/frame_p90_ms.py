"""frame_p90_ms: the 90th percentile of every request of the window, each
timed on the client from sending the bytes to the parsed reply; a failed
request counts as missing the tail (infinite)."""

import math


def read(run):
    times = sorted(r.seconds if r.reply is not None else math.inf
                   for r in run.requests)
    if not times:
        return None
    # The nearest-rank 90th percentile.
    value = times[max(0, math.ceil(0.9 * len(times)) - 1)]
    return value * 1e3 if math.isfinite(value) else None

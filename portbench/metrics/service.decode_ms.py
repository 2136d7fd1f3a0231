"""service.decode_ms: the mean over served frames of the reply's
`stats.decode_time`, the service handler's host clock around turning the
payload's lists into arrays (layer: HTTP service)."""


def read(run):
    times = [r.reply["stats"]["decode_time"] for r in run.served]
    return sum(times) / len(times) * 1e3 if times else None

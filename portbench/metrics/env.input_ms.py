"""env.input_ms: the mean over served frames of the env's
`stats.input_time` after each request: `set_input` on the host clock, which
ends in the observed cloud's readback (layer: recogniser and env host)."""


def read(run):
    times = [r.stats["input_time"] for r in run.served]
    return sum(times) / len(times) * 1e3 if times else None

"""env.candidates_ms: the mean over served frames of the host time in the
env's candidate generation (`generate_successors_6dof` /
`generate_successors_3dof`, timed by a span the harness wraps around them
in the traced run; layer: recogniser and env host)."""


def read(run):
    times = [r.candidates_s for r in run.served]
    if not times or not any(times):
        return None
    return sum(times) / len(times) * 1e3

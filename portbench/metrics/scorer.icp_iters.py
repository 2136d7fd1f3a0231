"""scorer.icp_iters: the mean over served frames of the reply's
`stats.icp_iterations`, the composed ICP refiners' loop iterations summed
over a frame's batches (each one 1-NN association and one host read; layer:
scorer). None where every count is 0 or the reply has none."""


def read(run):
    counts = [r.reply["stats"].get("icp_iterations", 0) for r in run.served]
    if not counts or not any(counts):
        return None
    return sum(counts) / len(counts)

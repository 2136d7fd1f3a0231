"""search.expands: the mean over served frames of the reply's
`stats.expands`, the tree search's node expansions (layer: search)."""


def read(run):
    counts = [r.reply["stats"]["expands"] for r in run.served]
    if not counts or not any(counts):
        return None
    return sum(counts) / len(counts)

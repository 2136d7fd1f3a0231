"""scorer.ms: the mean over served frames of the increase of the env's
cumulative `stats.gpu_time`, the host clock around each `score_pose_batch`
through its readbacks (layer: scorer)."""


def read(run):
    deltas = run.stat_deltas("gpu_time")
    return sum(deltas) / len(deltas) * 1e3 if deltas else None

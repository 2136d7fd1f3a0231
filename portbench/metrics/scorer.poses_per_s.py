"""scorer.poses_per_s: the window's increase of the env's cumulative
`stats.scenes_rendered` (poses scored) over its increase of
`stats.gpu_time` (layer: scorer)."""


def read(run):
    poses = sum(run.stat_deltas("scenes_rendered"))
    seconds = sum(run.stat_deltas("gpu_time"))
    return poses / seconds if seconds > 0 else None

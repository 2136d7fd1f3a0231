"""The shared reading of a stage's roofline share (the metric files
kernels.roofline.<stage>.py call it): the least time the chip needs for
the stage's work on every frame served in the traced window, from the
plain reference's counts (`portbench/work.py`), over the summed device
time of the stage's kernels in the trace (the name patterns in
metrics/kernels/<stage>/*.txt). None when the trace holds no such kernel
or the stage did no work."""

from portbench import trace, work


def share(run, stage: str, least):
    if run.trace is None or run.work is None:
        return None
    device_s = run.trace.kernel_seconds(
        trace.patterns(run.bench / "metrics" / "kernels" / stage))
    need = sum(least(run.work[r.frame]) for r in run.served)
    if not device_s or not need:
        return None
    return 100.0 * need / device_s


def icp(run):
    return share(run, "icp", work.icp_seconds)


def cost(run):
    return share(run, "cost", work.cost_seconds)

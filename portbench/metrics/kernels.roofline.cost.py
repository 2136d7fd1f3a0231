"""kernels.roofline.cost: the explained / unexplained cost stage's share of
its roofline, in % (see roofline.py; layer: kernels)."""

from portbench.metrics import roofline


def read(run):
    return roofline.cost(run)

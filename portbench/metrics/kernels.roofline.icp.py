"""kernels.roofline.icp: the ICP stage's share of its roofline, in % (see
roofline.py; layer: kernels)."""

from portbench.metrics import roofline


def read(run):
    return roofline.icp(run)

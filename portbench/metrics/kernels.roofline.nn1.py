"""kernels.roofline.nn1: the 1-NN association's share of its roofline, in %
(layer: kernels). The least time for the plain reference's association
pairs on the frames served, 9 float32 operations (3 sub, 3 mul, 3 add) per
(valid source, valid target) pair of each sweep, or its inputs read and
outputs written once (`Work.icp_bytes` of a GICP reference), whichever is
longer; over the device time of the kernels named in metrics/kernels/nn1/
(roofline.py). The kernel sweeps every pair of every pose on every loop
iteration, so this stays below its share of the dense work."""

from portbench import work
from portbench.metrics import roofline

NN1_PAIR_OPS = 9


def least_seconds(w) -> float:
    return work.least_seconds(w.icp_pair_sweeps * NN1_PAIR_OPS, w.icp_bytes)


def read(run):
    return roofline.share(run, "nn1", least_seconds)

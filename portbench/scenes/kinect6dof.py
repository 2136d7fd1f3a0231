"""6-DoF frames under the Kinect model's depth noise: the 6-DoF placement
(`frames.place_6dof`, on the built-in 6-DoF kind's rng, so a seed places
the scenes that kind places), the depth degraded by `sensor.KINECT` on an
rng of this kind's own, and the request built from the degraded depth in
mm, so that the candidate rows follow from what the sensor reports (their
number is whatever the rule gives for each frame). The masks are the clean
render's."""

from __future__ import annotations

import numpy as np

from portbench.scenes import frames, sensor

SIX_DOF = True


def make(config, traffic, bank, seed, device) -> list:
    place = np.random.default_rng([seed, 2])
    noise = np.random.default_rng([seed, 5])
    out = []
    for _ in range(traffic["frames"]):
        _, depth, label, trio = frames.place_6dof(config, bank, place, device)
        depth = sensor.KINECT.apply_depth(depth, noise)
        out.append(frames.request_6dof(config, traffic["mode"],
                                       np.rint(depth * 1000.0), label, trio))
    return out

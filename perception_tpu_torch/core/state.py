"""Graph states and discretisation for the pose search.

The port's own copy of `perception_tpu/core/state.py`: continuous object
states tagged with model id, symmetry and segmentation label; the world-grid
discretiser and discretised poses the tree search and MHA* deduplicate by
(the reference's DiscretizationManager and DiscPose); order-independent
graph-state hash keys and the state <-> id bijection of the hash manager.
"""

from __future__ import annotations

import dataclasses
import math

from perception_tpu_torch.core.pose import ContPose


@dataclasses.dataclass(frozen=True)
class Discretizer:
    """World-grid discretiser (reference DiscretizationManager), a value
    object the env refreshes from each input's search region."""

    x_min: float = -1.0
    x_max: float = 1.0
    y_min: float = -1.0
    y_max: float = 1.0
    res: float = 0.04           # translation resolution (m)
    theta_res: float = math.pi / 8

    def disc_x(self, x: float) -> int:
        return int(round((x - self.x_min) / self.res))

    def cont_x(self, xd: int) -> float:
        return xd * self.res + self.x_min

    def disc_y(self, y: float) -> int:
        return int(round((y - self.y_min) / self.res))

    def cont_y(self, yd: int) -> float:
        return yd * self.res + self.y_min

    def disc_angle(self, theta: float) -> int:
        two_pi = 2 * math.pi
        norm = theta % two_pi
        return int(round(norm / self.theta_res)) % max(
            1, int(round(two_pi / self.theta_res)))

    def cont_angle(self, td: int) -> float:
        return td * self.theta_res


@dataclasses.dataclass(frozen=True)
class DiscPose:
    """Discretised pose used for equality and hashing."""

    x: int
    y: int
    z: int
    roll: int
    pitch: int
    yaw: int

    @classmethod
    def from_cont(cls, pose: ContPose, disc: Discretizer) -> "DiscPose":
        if pose.uses_euler:
            roll, pitch, yaw = pose.roll, pose.pitch, pose.yaw
        else:
            rot = pose.rotation()
            yaw = math.atan2(rot[1, 0], rot[0, 0])
            pitch = math.asin(max(-1.0, min(1.0, -rot[2, 0])))
            roll = math.atan2(rot[2, 1], rot[2, 2])
        return cls(
            x=disc.disc_x(pose.x), y=disc.disc_y(pose.y),
            z=int(round(pose.z / disc.res)),
            roll=disc.disc_angle(roll), pitch=disc.disc_angle(pitch),
            yaw=disc.disc_angle(yaw))


@dataclasses.dataclass(frozen=True)
class ObjectState:
    """One placed object: model id, symmetry, pose, segmentation label and
    the index of the external candidate it came from (-1 = none)."""

    id: int
    symmetric: bool
    pose: ContPose
    segmentation_label_id: int = 0
    external_pose_id: int = -1

    def hash_key(self, disc: Discretizer) -> tuple:
        """Discrete, symmetry-aware identity: symmetric objects ignore yaw;
        an external candidate is its (model, candidate index)."""
        if self.external_pose_id >= 0:
            return (self.id, self.external_pose_id)
        dp = DiscPose.from_cont(self.pose, disc)
        yaw = 0 if self.symmetric else dp.yaw
        return (self.id, dp.x, dp.y, dp.z, dp.roll, dp.pitch, yaw)


@dataclasses.dataclass(frozen=True)
class GraphState:
    """A scene state: the placed objects, in placement order; its hash key
    does not depend on that order."""

    object_states: tuple[ObjectState, ...] = ()

    def append(self, obj: ObjectState) -> "GraphState":
        return GraphState(self.object_states + (obj,))

    @property
    def num_objects(self) -> int:
        return len(self.object_states)

    def hash_key(self, disc: Discretizer) -> tuple:
        return tuple(sorted(o.hash_key(disc) for o in self.object_states))


class StateHashManager:
    """State <-> id bijection over discrete graph-state identity."""

    def __init__(self, disc: Discretizer):
        self._disc = disc
        self._key_to_id: dict[tuple, int] = {}
        self._states: list[GraphState] = []

    def get_id(self, state: GraphState) -> int:
        key = state.hash_key(self._disc)
        sid = self._key_to_id.get(key)
        if sid is None:
            sid = len(self._states)
            self._key_to_id[key] = sid
            self._states.append(state)
        return sid

    def get_state(self, sid: int) -> GraphState:
        return self._states[sid]

    def __len__(self) -> int:
        return len(self._states)

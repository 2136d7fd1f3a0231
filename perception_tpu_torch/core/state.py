"""Object and graph states of the greedy search.

The port's own copy of the two state types of `perception_tpu/core/state.py`
the greedy path uses. The discretiser, state hashing and the hash manager
belong to the tree search, which is not ported yet.
"""

from __future__ import annotations

import dataclasses

from perception_tpu_torch.core.pose import ContPose


@dataclasses.dataclass(frozen=True)
class ObjectState:
    """One placed object: model id, symmetry, pose, segmentation label and
    the index of the external candidate it came from (-1 = none)."""

    id: int
    symmetric: bool
    pose: ContPose
    segmentation_label_id: int = 0
    external_pose_id: int = -1


@dataclasses.dataclass(frozen=True)
class GraphState:
    """A scene state: the placed objects, in placement order."""

    object_states: tuple[ObjectState, ...] = ()

    def append(self, obj: ObjectState) -> "GraphState":
        return GraphState(self.object_states + (obj,))

    @property
    def num_objects(self) -> int:
        return len(self.object_states)

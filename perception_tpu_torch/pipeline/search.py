"""Multi-object scene search over composed states (PERCH 1.0's tree mode).

Counterpart of `perception_tpu/pipeline/search.py`: beam search over levels
of "scene states" (sets of placed objects), one level per object. Expanding a
level scores every frontier node's successors (all candidates of its
unplaced models) in batched `score_object_states` calls against the node's
composed source image: the observation at the root, then the node's objects
composed on top of it (min depth), so placed objects occlude their
successors. `beam_width` nodes survive per level, by g + edge cost;
beam_width=1 is greedy commit ordering.

Options: `lazy_k` re-scores only each model's best `lazy_k` candidates by
their cached root cost below the root; `counted_pixels` charges each placed
object the not-yet-claimed observed pixels inside its footprint (3-DoF) or
mesh (6-DoF), so no observed point counts twice along a branch; a heuristic
orders each model's candidates before `max_successors_per_model` cuts them.

Single-object strided renders are cached by candidate value. Composed images
live on the host as int32 NumPy arrays; each expansion copies its node's to
the env's device.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np

from perception_tpu_torch.core.state import GraphState, ObjectState
from perception_tpu_torch.utils.stats import EnvStats, span


@dataclasses.dataclass
class _Node:
    state: GraphState
    g: int                       # accumulated cost
    source_depth: np.ndarray     # composed strided depth (render units)
    source_label: np.ndarray     # composed strided labels (1-based model id)
    placed_ids: frozenset
    counted: np.ndarray | None = None   # [h, w] observed pixels claimed by
                                        # placed objects (counted_pixels)


class TreeSearch:
    def __init__(
        self,
        env,
        beam_width: int = 2,
        candidates_per_model: Sequence[ObjectState] | None = None,
        heuristic: Callable[[ObjectState], float] | None = None,
        max_successors_per_model: int = 512,
        lazy_k: int = 0,
        counted_pixels: bool = False,
    ):
        """candidates_per_model: every candidate of every model (default:
        the env's 3-DoF grid successors)."""
        self.env = env
        self.beam_width = beam_width
        self.counted_pixels = counted_pixels
        self.heuristic = heuristic
        self.max_successors_per_model = max_successors_per_model
        self.lazy_k = lazy_k
        self._root_costs: dict[tuple, int] = {}
        self._candidates = candidates_per_model
        self._render_cache: dict[tuple, np.ndarray] = {}
        self._obs_grid = None
        self.stats = EnvStats()

    # ------------------------------------------------------------------

    def _initial_candidates(self) -> dict[int, list[ObjectState]]:
        states = (self._candidates if self._candidates is not None
                  else self.env.generate_successors_3dof())
        per_model: dict[int, list[ObjectState]] = {}
        for st in states:
            per_model.setdefault(st.id, []).append(st)
        for mid in per_model:
            if self.heuristic is not None:
                per_model[mid].sort(key=self.heuristic)
            per_model[mid] = per_model[mid][:self.max_successors_per_model]
        return per_model

    @staticmethod
    def _state_key(st: ObjectState) -> tuple:
        """Value key of a candidate (for the render and root-cost caches)."""
        if st.external_pose_id >= 0:
            return (st.id, st.external_pose_id)
        p = st.pose
        return (st.id, round(p.x, 6), round(p.y, 6), round(p.z, 6),
                round(p.roll, 6), round(p.pitch, 6), round(p.yaw, 6))

    def _candidate_depths(self, states: list[ObjectState]) -> np.ndarray:
        """Strided single-object depth renders [N, h, w] through the cache;
        the misses render in one batched call (`render_strided`)."""
        miss = [s for s in states
                if self._state_key(s) not in self._render_cache]
        if miss:
            out = self.env.render_strided(miss)
            for s, d in zip(miss, out.depth.cpu().numpy()):
                self._render_cache[self._state_key(s)] = d
                self.stats.scenes_rendered += 1
        return np.stack([self._render_cache[self._state_key(s)]
                         for s in states])

    def _observed_grid(self):
        """(depth [h, w] render units, camera points [h, w, 3], world
        points [h, w, 3]) of the original observation's strided grid."""
        if self._obs_grid is None:
            env = self.env
            stride = int(env.perch.gpu_stride)
            cam = env.camera
            obs = env._scene.source_depth.cpu().numpy()
            depth = obs.astype(np.float64)
            ys, xs = np.mgrid[0:depth.shape[0], 0:depth.shape[1]]
            z = depth / env.env.gpu_depth_factor
            x = (xs * stride - cam.cx) / cam.fx * z
            y = (ys * stride - cam.cy) / cam.fy * z
            pts_cam = np.stack([x, y, z], axis=-1)
            c2w = env._input.cam_to_world
            pts_world = pts_cam @ c2w[:3, :3].T + c2w[:3, 3]
            self._obs_grid = (obs, pts_cam, pts_world)
        return self._obs_grid

    def _counted_costs(self, node: _Node, scored: list) -> list[tuple]:
        """Counted-pixels true costs: for each survivor, (target% +
        unexplained share of the observed pixels it claims, the claimed
        mask). A survivor claims the node's unclaimed observed pixels
        inside its mesh (6-DoF) or footprint (3-DoF)."""
        env = self.env
        obs_depth, pts_cam, pts_world = self._observed_grid()
        valid = (obs_depth > 0) & (node.counted == 0)
        thresh = env.perch.sensor_resolution * env.env.gpu_depth_factor
        depths = self._candidate_depths([su.state for su in scored])
        out = []
        for su, cand_depth in zip(scored, depths):
            model = env.bank.models[su.state.id]
            rad = model.inflation_factor * model.circumscribed_radius_3d
            inside = np.zeros_like(valid)
            if env._input.use_external_pose_list:
                center = su.adjusted_pose_cam[:3, 3]
                near = valid & (
                    ((pts_cam - center) ** 2).sum(axis=-1) <= rad * rad)
                if near.any():
                    inside[near] = model.points_inside(
                        pts_cam[near], transform=su.adjusted_pose_cam,
                        inflation=model.inflation_factor)
            else:
                p = su.state.pose
                near = valid & (
                    ((pts_world[..., :2] - [p.x, p.y]) ** 2).sum(axis=-1)
                    <= rad * rad)
                if near.any():
                    inside[near] = model.points_inside_footprint(
                        pts_world[near][:, :2],
                        yaw_cos_sin=(np.cos(p.yaw), np.sin(p.yaw)),
                        xy=(p.x, p.y))
            claimed = valid & inside
            explained = (cand_depth > 0) & (
                np.abs(cand_depth.astype(np.float64) - obs_depth) <= thresh)
            n_claimed = int(claimed.sum())
            src = (100.0 * (claimed & ~explained).sum() / n_claimed
                   if n_claimed else 100.0)
            out.append((int(su.target_cost + src), claimed))
        return out

    def _compose(self, node: _Node, obj: ObjectState):
        """The node's composed images with obj's cached single-object render
        on top (integer min of depth; obj's label where it is closer). A miss
        renders obj alone as `prefetch_singles` does."""
        key = self._state_key(obj)
        if key not in self._render_cache:
            self.prefetch_singles([obj])
        d = self._render_cache[key]
        closer = (d > 0) & ((node.source_depth == 0) | (d < node.source_depth))
        new_depth = np.where(closer, d, node.source_depth)
        new_label = np.where(closer, obj.id + 1, node.source_label)
        return new_depth.astype(np.int32), new_label.astype(np.int32)

    def prefetch_singles(self, objs: Sequence[ObjectState],
                         chunk: int = 64) -> None:
        """Fill the render cache for the objects `_compose` will place: the
        misses render alone at full resolution as `render_composite` renders
        them (`render_full`), `chunk` per call, strided."""
        env = self.env
        miss, keys = [], set()
        for s in objs:
            key = self._state_key(s)
            if key not in self._render_cache and key not in keys:
                keys.add(key)
                miss.append(s)
        for lo in range(0, len(miss), chunk):
            part = miss[lo:lo + chunk]
            out = env.render_full(part)
            for s, d in zip(part, env.strided(out.depth).cpu().numpy()):
                self._render_cache[self._state_key(s)] = d.astype(np.int32)
                self.stats.scenes_rendered += 1

    def root(self) -> _Node:
        """The search's root: the observation is the occlusion source (so
        clutter in the input can occlude candidates), no labels."""
        env = self.env
        depth = env._scene.source_depth.cpu().numpy().astype(np.int32)
        return _Node(GraphState(), 0, depth, np.zeros_like(depth),
                     frozenset(),
                     counted=(np.zeros(depth.shape, bool)
                              if self.counted_pixels else None))

    # ------------------------------------------------------------------

    def plan(self) -> GraphState:
        per_model = self._initial_candidates()
        if not per_model:
            return GraphState()
        frontier = [self.root()]
        for _ in range(len(per_model)):
            expansions: list[tuple] = []
            for node in frontier:
                cands: list[ObjectState] = []
                for mid in per_model:
                    if mid in node.placed_ids:
                        continue
                    pool = per_model[mid]
                    if self.lazy_k and node.state.num_objects > 0:
                        pool = sorted(
                            pool,
                            key=lambda s: self._root_costs.get(
                                self._state_key(s), 10**9))[:self.lazy_k]
                    cands.extend(pool)
                if not cands:
                    continue
                self.stats.expands += 1
                with span("search.expand") as sp:
                    sp.add("candidates", len(cands))
                    scored = self.env.score_object_states(
                        cands, do_icp=False,
                        source=(node.source_depth, node.source_label))
                    if node.state.num_objects == 0:
                        for su, st in zip(scored, cands):
                            self._root_costs[self._state_key(st)] = (
                                su.cost if su.cost >= 0 else 10**9)
                    survivors = [su for su in scored if su.cost >= 0]
                    if self.counted_pixels:
                        for su, (cost, claimed) in zip(
                                survivors,
                                self._counted_costs(node, survivors)):
                            expansions.append((node, su, cost, claimed))
                    else:
                        expansions.extend(
                            (node, su, su.cost, None) for su in survivors)
            if not expansions:
                break
            expansions.sort(key=lambda e: e[0].g + e[2])

            new_frontier: list[_Node] = []
            seen_keys = set()
            for node, su, cost, claimed in expansions:
                if len(new_frontier) >= self.beam_width:
                    break
                obj = su.state
                key = (node.placed_ids, obj.id,
                       round(obj.pose.x, 3), round(obj.pose.y, 3))
                if key in seen_keys:
                    continue
                seen_keys.add(key)
                depth, label = self._compose(node, obj)
                new_frontier.append(_Node(
                    state=node.state.append(obj), g=node.g + cost,
                    source_depth=depth, source_label=label,
                    placed_ids=node.placed_ids | {obj.id},
                    counted=(node.counted | claimed
                             if claimed is not None else None)))
            if not new_frontier:
                break
            frontier = new_frontier

        best = min(frontier, key=lambda n: n.g)
        self.stats.cost = best.g
        return best.state

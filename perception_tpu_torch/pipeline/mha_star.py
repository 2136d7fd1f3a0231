"""Multi-Heuristic A* over scene states.

Counterpart of `perception_tpu/pipeline/mha_star.py` (the reference's
improved MHA* driving the env's successor generation): an anchor queue
ordered by g + w1 * h_anchor (h_anchor = 0, admissible) and one
inadmissible queue per heuristic, expanded round-robin while an inadmissible
queue's minimum key stays within w2 times the anchor's (Aine et al., SMHA*).
States deduplicate by their discretised, symmetry-aware hash key.

Expanding a state scores all its successor edges (every candidate of every
unplaced model) in batched `score_object_states` calls against the state's
composed source image, through `TreeSearch`'s helpers; the children's
single-object renders are batched into the shared render cache first.
"""

from __future__ import annotations

import dataclasses
import heapq
import itertools
from typing import Callable, Sequence

import numpy as np

from perception_tpu_torch.core.state import GraphState, ObjectState
from perception_tpu_torch.pipeline.search import TreeSearch
from perception_tpu_torch.utils.stats import EnvStats


@dataclasses.dataclass
class _Node:
    state: GraphState
    g: int
    source_depth: np.ndarray
    source_label: np.ndarray
    placed_ids: frozenset
    closed_anchor: bool = False
    closed_inad: bool = False


class MHAStarPlanner:
    def __init__(
        self,
        env,
        candidates_per_model: Sequence[ObjectState],
        heuristics: Sequence[Callable[[ObjectState], float]] = (),
        w1: float = 3.0,
        w2: float = 1.4,
        max_expansions: int = 200,
        max_successors_per_model: int = 256,
    ):
        """Each model keeps its first max_successors_per_model candidates,
        in the order given."""
        self.env = env
        self.w1 = w1
        self.w2 = w2
        self.max_expansions = max_expansions
        self.stats = EnvStats()
        self._heuristics = list(heuristics)
        self._per_model: dict[int, list[ObjectState]] = {}
        for st in candidates_per_model:
            self._per_model.setdefault(st.id, []).append(st)
        for mid in self._per_model:
            self._per_model[mid] = \
                self._per_model[mid][:max_successors_per_model]
        self._counter = itertools.count()
        self._h_inad_mins: dict[int, dict[int, float]] = {}
        self._search = TreeSearch(env)

    # -- heuristics ----------------------------------------------------

    def _h_anchor(self, node: _Node) -> float:
        """Admissible: 0 (an edge costs 0 for a perfect placement)."""
        return 0.0

    def _h_inad(self, idx: int, node: _Node) -> float:
        """Inadmissible queue idx: the sum over unplaced models of their
        cheapest candidate's heuristic value (the minima cached per
        model)."""
        mins = self._h_inad_mins.setdefault(idx, {
            mid: min(self._heuristics[idx](c) for c in cands)
            for mid, cands in self._per_model.items()})
        return sum(v for mid, v in mins.items()
                   if mid not in node.placed_ids)

    # -- expansion -----------------------------------------------------

    def _expand(self, node: _Node) -> list[_Node]:
        cands: list[ObjectState] = []
        for mid, pool in self._per_model.items():
            if mid not in node.placed_ids:
                cands.extend(pool)
        if not cands:
            return []
        self.stats.expands += 1
        search = self._search
        scored = self.env.score_object_states(
            cands, do_icp=False, source=(node.source_depth, node.source_label))
        survivors = [su for su in scored if su.cost >= 0]
        search.prefetch_singles([su.state for su in survivors])
        out = []
        for su in survivors:
            obj = su.state
            depth, label = search._compose(node, obj)
            out.append(_Node(
                state=node.state.append(obj), g=node.g + su.cost,
                source_depth=depth, source_label=label,
                placed_ids=node.placed_ids | {obj.id}))
        return out

    # -- main loop -----------------------------------------------------

    def plan(self) -> GraphState:
        env = self.env
        open_q: list[list] = [[] for _ in range(1 + len(self._heuristics))]
        root = self._search.root()
        best_goal: _Node | None = None
        seen: dict[tuple, int] = {}

        def push(node: _Node):
            key = node.state.hash_key(env._disc)
            old = seen.get(key)
            if old is not None and old <= node.g:
                return
            seen[key] = node.g
            k0 = node.g + self.w1 * self._h_anchor(node)
            heapq.heappush(open_q[0], (k0, next(self._counter), node))
            for i in range(len(self._heuristics)):
                ki = node.g + self.w1 * self._h_inad(i, node)
                heapq.heappush(open_q[i + 1], (ki, next(self._counter), node))

        push(_Node(root.state, 0, root.source_depth, root.source_label,
                   frozenset()))
        total_levels = len(self._per_model)
        expansions = 0
        rr = 0
        while open_q[0] and expansions < self.max_expansions:
            # Round-robin over the inadmissible queues whose minimum key
            # passes the anchor gate; else the anchor.
            anchor_key = open_q[0][0][0]
            qi = 0
            if len(open_q) > 1:
                for step in range(len(open_q) - 1):
                    cand = 1 + (rr + step) % (len(open_q) - 1)
                    if (open_q[cand]
                            and open_q[cand][0][0] <= self.w2 * anchor_key):
                        qi = cand
                        rr = (rr + step + 1) % (len(open_q) - 1)
                        break
            _, _, node = heapq.heappop(open_q[qi])

            # SMHA* closed lists: an anchor expansion closes a node in every
            # queue, an inadmissible one in the inadmissible queues.
            if node.closed_anchor or (qi > 0 and node.closed_inad):
                continue
            if qi == 0:
                node.closed_anchor = True
            node.closed_inad = True

            if node.state.num_objects == total_levels:
                if best_goal is None or node.g < best_goal.g:
                    best_goal = node
                break

            expansions += 1
            for child in self._expand(node):
                if child.state.num_objects == total_levels:
                    if best_goal is None or child.g < best_goal.g:
                        best_goal = child
                push(child)
            if best_goal is not None and best_goal.g <= anchor_key:
                break

        self.stats.expands = expansions
        self.stats.scenes_rendered = self._search.stats.scenes_rendered
        if best_goal is None:
            # The deepest, then cheapest, partial assignment.
            frontier = [item[2] for q in open_q for item in q]
            if not frontier:
                return GraphState()
            best_goal = max(frontier,
                            key=lambda n: (n.state.num_objects, -n.g))
        self.stats.cost = best_goal.g
        return best_goal.state

"""Recognition API: the reference ObjectRecognizer's three ways to localise.

Counterpart of `perception_tpu/pipeline/recognizer.py`:
`localize_objects_greedy_render` (PERCH 2.0: 6-DoF candidates, ICP, greedy
argmin), `localize_objects_greedy_icp` (the brute-force 3-DoF baseline:
every grid candidate scored with ICP, per model the best rendered fitness)
and `localize_objects` (PERCH 1.0: the tree search over composed scenes).
Each sets the input and reports world poses.
"""

from __future__ import annotations

import dataclasses
import os
import time

import numpy as np
import torch

from perception_tpu_torch.core.config import (
    CameraIntrinsics,
    EnvConfig,
    PerchConfig,
)
from perception_tpu_torch.core.mesh import MeshModel, ModelBank
from perception_tpu_torch.core.pose import ContPose
from perception_tpu_torch.core.state import GraphState, ObjectState
from perception_tpu_torch.io.model_cache import load_model_cached
from perception_tpu_torch.io.poses_file import (
    read_poses_file,
    write_cost_dump,
    write_output_poses,
    write_output_stats,
)
from perception_tpu_torch.pipeline.env import PerceptionEnv, RecognitionInput
from perception_tpu_torch.pipeline.search import TreeSearch
from perception_tpu_torch.utils.stats import span


@dataclasses.dataclass
class ModelSpec:
    """One model-bank entry (fields as the JAX ModelSpec)."""

    name: str
    path: str
    flipped: bool = False
    symmetric: bool = False
    symmetry_mode: int = 0
    search_resolution: float = 0.06
    num_variants: int = 1


@dataclasses.dataclass
class LocalizationResult:
    names: list[str]
    poses: list[ContPose]
    object_transforms: list[np.ndarray]          # incl. preprocessing
    preprocessing_transforms: list[np.ndarray]
    stats: object


class ObjectRecognizer:
    def __init__(
        self,
        model_specs: list[ModelSpec],
        camera: CameraIntrinsics,
        perch: PerchConfig | None = None,
        env_cfg: EnvConfig | None = None,
        mesh_in_mm: bool = False,
        mesh_scaling_factor: float = 0.001,
        use_external_pose_list: bool = True,
        target_triangles: int = 1024,
        device: str | torch.device = "cuda",
        model_cache_dir: str | None = None,
    ):
        models = [load_model_cached(
            spec.path, cache_dir=model_cache_dir, name=spec.name,
            mesh_in_mm=mesh_in_mm,
            scaling_factor=mesh_scaling_factor, flipped=spec.flipped,
            use_external_pose_list=use_external_pose_list,
            target_triangles=target_triangles,
            symmetric=spec.symmetric, symmetry_mode=spec.symmetry_mode)
            for spec in model_specs]
        self._init(ModelBank.from_models(models), camera, perch, env_cfg,
                   device, model_specs)

    @classmethod
    def from_models(cls, models: list[MeshModel], camera: CameraIntrinsics,
                    perch: PerchConfig | None = None,
                    env_cfg: EnvConfig | None = None,
                    t_cap: int | None = None,
                    device: str | torch.device = "cuda"
                    ) -> "ObjectRecognizer":
        """A recogniser over in-memory models (no mesh files)."""
        self = cls.__new__(cls)
        specs = [ModelSpec(name=m.name, path="") for m in models]
        self._init(ModelBank.from_models(models, t_cap=t_cap), camera, perch,
                   env_cfg, device, specs)
        return self

    def _init(self, bank: ModelBank, camera, perch, env_cfg, device,
              specs) -> None:
        self.env = PerceptionEnv(bank, camera, perch, env_cfg, device=device)
        self.specs = specs
        self.last_state: GraphState | None = None

    @property
    def bank(self) -> ModelBank:
        return self.env.bank

    def warmup(self) -> float:
        """Localise a synthetic scene of the bank's own models once, so the
        first request finds the kernels built and loaded. Returns seconds."""
        t0 = time.perf_counter()
        n = len(self.bank.models)
        states, pose_lists = [], {}
        for i, m in enumerate(self.bank.models):
            y = 0.12 * (i - (n - 1) / 2.0)
            states.append(ObjectState(
                id=i, symmetric=m.symmetric,
                pose=ContPose.from_quat(0.58, y, -0.02, 0, 0, 0, 1),
                segmentation_label_id=i + 1))
            pose_lists[m.name] = np.asarray([[0.58, y, -0.02, 0, 0, 0, 1.0]])
        self.env.set_observation_from_states(states)
        self.localize_objects_greedy_render(self.env._input, pose_lists)
        return time.perf_counter() - t0

    def localize_objects_greedy_render(
        self, rin: RecognitionInput, pose_lists: dict[str, np.ndarray],
        output_dir: str | None = None,
    ) -> LocalizationResult:
        env = self.env
        with span("recognizer.localize"):
            env.set_input(rin)
            candidates = env.generate_successors_6dof(pose_lists)
            state, chosen = env.compute_greedy_poses(candidates)
            result = self._result_from_state(state)
        env.stats.update_peak_memory(env.device)
        if output_dir is not None:
            self._write_outputs(output_dir, result, chosen)
        return result

    def localize_objects_greedy_icp(
        self, rin: RecognitionInput, output_dir: str | None = None,
    ) -> LocalizationResult:
        """The brute-force baseline: every 3-DoF grid candidate scored with
        ICP; per model the candidate with the lowest rendered cost (the
        baseline ignores the observed cost), reported at its post-ICP pose.
        As in the JAX package, without the reference's collision commit
        order (`compute_greedy_poses(collision_ordering=True)` has it;
        ROADMAP.md, Queue 3)."""
        env = self.env
        with span("recognizer.localize"):
            t0 = time.perf_counter()
            env.set_input(rin)
            scored = env.score_object_states(env.generate_successors_3dof(),
                                             do_icp=True)
            with span("env.argmin"):
                best = {}
                for su in scored:
                    if su.cost < 0:
                        continue
                    mid = su.state.id
                    if (mid not in best
                            or su.target_cost < best[mid].target_cost):
                        best[mid] = su
            state = GraphState()
            for mid in sorted(best):
                su = best[mid]
                state = state.append(ObjectState(
                    id=mid, symmetric=su.state.symmetric,
                    pose=env.camera_to_world_pose(su.adjusted_pose_cam, mid),
                    segmentation_label_id=su.state.segmentation_label_id))
            env.stats.time = time.perf_counter() - t0
            result = self._result_from_state(state)
        env.stats.update_peak_memory(env.device)
        if output_dir is not None:
            self._write_outputs(output_dir, result, list(best.values()))
        return result

    def localize_objects(self, rin: RecognitionInput,
                         output_dir: str | None = None,
                         **search_kwargs) -> LocalizationResult:
        """The tree search (`TreeSearch(env, **search_kwargs)`) over the
        3-DoF grid candidates."""
        env = self.env
        with span("recognizer.localize"):
            t0 = time.perf_counter()
            env.set_input(rin)
            search = TreeSearch(env, **search_kwargs)
            state = search.plan()
            env.stats.expands = search.stats.expands
            env.stats.time = time.perf_counter() - t0
            result = self._result_from_state(state)
        env.stats.update_peak_memory(env.device)
        if output_dir is not None:
            self._write_outputs(output_dir, result, [])
        return result

    def _result_from_state(self, state: GraphState) -> LocalizationResult:
        self.last_state = state
        names, poses, tfs, pres = [], [], [], []
        # Segment names name instances only in 6-DoF mode; a 3-DoF input is
        # one segment.
        rin = self.env._input
        seg_names = (rin.segmented_object_names
                     if rin is not None and rin.use_external_pose_list
                     else [])
        for obj in state.object_states:
            model = self.bank.models[obj.id]
            lid = obj.segmentation_label_id
            names.append(seg_names[lid - 1] if 1 <= lid <= len(seg_names)
                         else model.name)
            poses.append(obj.pose)
            pre = model.preprocessing_transform
            tfs.append(obj.pose.transform() @ pre)
            pres.append(pre)
        return LocalizationResult(
            names=names, poses=poses, object_transforms=tfs,
            preprocessing_transforms=pres, stats=self.env.stats)

    def _write_outputs(self, output_dir: str, result: LocalizationResult,
                       chosen) -> None:
        os.makedirs(output_dir, exist_ok=True)
        write_output_poses(
            os.path.join(output_dir, "output_poses.txt"),
            list(zip(result.names, result.poses,
                     result.preprocessing_transforms)))
        write_output_stats(
            os.path.join(output_dir, "output_stats.txt"), self.env.stats)
        if chosen:
            write_cost_dump(
                os.path.join(output_dir, "cost_dump.json"), chosen, self.env)

    def read_pose_lists(self, rendered_root_dir: str,
                        names: list[str] | None = None
                        ) -> dict[str, np.ndarray]:
        """Per-object `<rendered_root_dir>/<name>/poses.txt` candidate files
        (the 6-DoF candidate contract) -> {name: [K, 7]}; objects without a
        file are left out."""
        out = {}
        for name in (names or [s.name for s in self.specs]):
            path = os.path.join(rendered_root_dir, name, "poses.txt")
            if os.path.exists(path):
                out[name] = read_poses_file(path)
        return out

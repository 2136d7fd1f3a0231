"""Carry state from the JAX package into the port.

The JAX package's host types are plain dataclasses of numpy arrays (models,
banks, configurations) or hold arrays that `np.asarray` reads (a JAX
ObservedScene, the env's Lab bank). The functions here read their fields and
build the port's own types and tensors, importing nothing of the JAX
package; the tests use them to feed both packages identical inputs.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from perception_tpu_torch.core.mesh import MeshModel, ModelBank
from perception_tpu_torch.core.pose import ContPose
from perception_tpu_torch.core.state import Discretizer, ObjectState
from perception_tpu_torch.pipeline.env import RecognitionInput
from perception_tpu_torch.pipeline.heuristics import Detection
from perception_tpu_torch.pipeline.scorer import ObservedScene, ScorerConfig


def tensor(a, device: str | torch.device = "cpu",
           dtype: torch.dtype | None = None) -> torch.Tensor:
    """Any array (numpy, JAX, list) -> a torch tensor on `device`."""
    return torch.as_tensor(np.array(a), dtype=dtype, device=device)


def dataclass_from_jax(obj, cls, **overrides):
    """The port's dataclass `cls` with the same-named fields of `obj` (a
    JAX PerchConfig, EnvConfig, CameraIntrinsics, ...)."""
    fields = {f.name: getattr(obj, f.name) for f in dataclasses.fields(cls)}
    fields.update(overrides)
    return cls(**fields)


def models_from_jax(models) -> list[MeshModel]:
    """JAX MeshModels -> the port's, field by field."""
    return [dataclass_from_jax(m, MeshModel) for m in models]


def bank_from_jax(bank) -> ModelBank:
    """A JAX ModelBank -> the port's (the same arrays)."""
    return ModelBank(models=models_from_jax(bank.models),
                     tri_verts=np.asarray(bank.tri_verts),
                     tri_colors=np.asarray(bank.tri_colors),
                     tri_valid=np.asarray(bank.tri_valid),
                     backface_cull=np.asarray(bank.backface_cull))


def bank_tensors(bank: ModelBank, device: str | torch.device = "cpu"
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                            torch.Tensor]:
    """(tri_verts [M, T, 3, 3] f32, tri_colors [M, T, 3] f32,
    tri_valid [M, T] bool, backface_cull [M] bool)."""
    return (tensor(bank.tri_verts, device, torch.float32),
            tensor(bank.tri_colors, device, torch.float32),
            tensor(bank.tri_valid, device, torch.bool),
            tensor(bank.backface_cull, device, torch.bool))


def scene_from_jax(scene, device: str | torch.device = "cpu") -> ObservedScene:
    """A JAX ObservedScene -> the port's ObservedScene (the fields the port's
    scorer reads: the segment colours and their Lab, and the organised
    maps, included)."""
    return ObservedScene(
        seg_xyz=tensor(scene.seg_xyz, device, torch.float32),
        seg_rgb=tensor(scene.seg_rgb, device, torch.float32),
        seg_lab=tensor(scene.seg_lab, device, torch.float32),
        seg_valid=tensor(scene.seg_valid, device, torch.bool),
        seg_normals=tensor(scene.seg_normals, device, torch.float32),
        map_xyz=tensor(scene.map_xyz, device, torch.float32),
        map_normals=tensor(scene.map_normals, device, torch.float32),
        map_valid=tensor(scene.map_valid, device, torch.bool),
        map_label=tensor(scene.map_label, device, torch.int32),
        source_depth=tensor(scene.source_depth, device, torch.int32),
        source_label=tensor(scene.source_label, device, torch.int32))


def scorer_config_from_jax(cfg) -> ScorerConfig:
    """A JAX ScorerConfig -> the port's, field by field. The kernel backend
    keeps its raster ("pallas" -> the coefficient-table kernel, "pallas_bin"
    and its interpreter -> the bin kernel); the direct family, "auto" and
    "xla" (whose composed path the port has not) map to "auto", the direct
    kernel."""
    backend = {"pallas": "pallas", "pallas_bin": "pallas_bin",
               "pallas_bin_interpret": "pallas_bin"}.get(cfg.backend, "auto")
    return dataclass_from_jax(cfg, ScorerConfig, backend=backend)


def discretizer_from_jax(disc) -> Discretizer:
    """A JAX Discretizer -> the port's (the same grid)."""
    return dataclass_from_jax(disc, Discretizer)


def states_from_jax(states) -> list[ObjectState]:
    """JAX ObjectStates -> the port's, poses field by field."""
    return [dataclass_from_jax(s, ObjectState,
                               pose=dataclass_from_jax(s.pose, ContPose))
            for s in states]


def input_from_jax(rin) -> RecognitionInput:
    """A JAX RecognitionInput -> the port's (the 3-DoF region included)."""
    return dataclass_from_jax(rin, RecognitionInput)


def detections_from_jax(detections) -> list[Detection]:
    """JAX Detections -> the port's."""
    return [dataclass_from_jax(d, Detection) for d in detections]

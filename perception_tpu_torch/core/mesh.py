"""Model-bank construction without the JAX package's device modules.

`perception_tpu.core.mesh.ModelBank.from_models` and `.decimated` read the
raster's triangle capacity from `perception_tpu.ops.rasterizer`, which
imports jax. These two functions produce the same `ModelBank` (same morton
triangle order, padding and LOD decimation) from the port's own constant, so
the port never imports jax. Everything else in `perception_tpu.core.mesh`
(mesh loading, decimation, `MeshModel`, `surface_samples`) is reused as is.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from perception_tpu.core.mesh import (
    MeshModel,
    ModelBank,
    _morton_order,
    analyze_winding,
    decimate,
)
from perception_tpu_torch.ops.rasterizer import MAX_TRIS


def bank_from_models(models: list[MeshModel],
                     t_cap: int | None = None) -> ModelBank:
    """Stack models into a padded ModelBank (ModelBank.from_models)."""
    if t_cap is None:
        t_cap = max(m.num_triangles for m in models)
    if t_cap > MAX_TRIS:
        raise ValueError(
            f"t_cap={t_cap} exceeds the raster key's triangle capacity "
            f"MAX_TRIS={MAX_TRIS}; decimate the models harder")
    m_count = len(models)
    tri_verts = np.zeros((m_count, t_cap, 3, 3), dtype=np.float32)
    tri_colors = np.zeros((m_count, t_cap, 3), dtype=np.float32)
    tri_valid = np.zeros((m_count, t_cap), dtype=bool)
    for i, m in enumerate(models):
        if m.num_triangles > t_cap:
            raise ValueError(
                f"model {m.name} has {m.num_triangles} triangles > cap {t_cap}")
        t = m.num_triangles
        order = _morton_order(m.tri_verts[:t].mean(axis=1))
        tri_verts[i, :t] = m.tri_verts[:t][order]
        tri_colors[i, :t] = m.tri_colors[:t][order]
        tri_valid[i, :t] = True
    return ModelBank(
        models=models, tri_verts=tri_verts, tri_colors=tri_colors,
        tri_valid=tri_valid,
        backface_cull=np.asarray([m.backface_cullable for m in models],
                                 dtype=bool))


def decimated_bank(bank: ModelBank, target_triangles: int) -> ModelBank:
    """Render-LOD bank: every model re-decimated to <= target_triangles
    (ModelBank.decimated)."""
    lod_models = []
    for m in bank.models:
        soup = m.tri_verts[:m.num_triangles].astype(np.float64).reshape(-1, 3)
        verts, inv = np.unique(soup.round(decimals=7), axis=0,
                               return_inverse=True)
        faces = inv.reshape(-1, 3)
        vcol = np.full((len(verts), 3), 128.0)
        for c in range(3):
            vcol[faces[:, c]] = m.tri_colors[:m.num_triangles]
        dverts, dfaces, dcol = decimate(verts, faces, vcol, target_triangles)
        cullable, dfaces = analyze_winding(dverts, dfaces)
        tri_colors = (dcol[dfaces].mean(axis=1) if dcol is not None
                      else np.full((len(dfaces), 3), 128.0))
        lod_models.append(dataclasses.replace(
            m, tri_verts=dverts[dfaces].astype(np.float32),
            tri_colors=tri_colors.astype(np.uint8),
            backface_cullable=bool(cullable and m.backface_cullable)))
    return bank_from_models(lod_models, t_cap=target_triangles)

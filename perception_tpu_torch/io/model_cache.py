"""Cross-run cache of preprocessed models.

The port's own copy of `perception_tpu/io/model_cache.py`: `load_model`'s
result (parse + decimate + winding analysis) memoised to an .npz keyed by
the file's identity, the preprocessing arguments and the decimator
(`decimate_mode()`, so a QEM load is never served a clustered entry), so a
second process reads one file instead of re-decimating. The key equals the
JAX package's for the same file, arguments and decimator.
"""

from __future__ import annotations

import hashlib
import os

import numpy as np

from perception_tpu_torch.core.mesh import MeshModel, decimate_mode, load_model

_CACHE_VERSION = 2


def _cache_key(path: str, kwargs: dict) -> str:
    st = os.stat(path)
    payload = repr((os.path.abspath(path), st.st_size, int(st.st_mtime),
                    sorted(kwargs.items()), _CACHE_VERSION, decimate_mode()))
    return hashlib.sha256(payload.encode()).hexdigest()[:24]


def load_model_cached(path: str, cache_dir: str | None = None,
                      **kwargs) -> MeshModel:
    """`load_model` with an .npz result cache in cache_dir (None:
    $PT_MODEL_CACHE_DIR; unset, no caching)."""
    cache_dir = cache_dir or os.environ.get("PT_MODEL_CACHE_DIR")
    if not cache_dir:
        return load_model(path, **kwargs)
    os.makedirs(cache_dir, exist_ok=True)
    name = kwargs.get("name") or os.path.basename(path)
    fname = os.path.join(
        cache_dir, f"{os.path.basename(name)}-{_cache_key(path, kwargs)}.npz")
    if os.path.exists(fname):
        z = np.load(fname, allow_pickle=False)
        return MeshModel(
            name=str(z["name"]), tri_verts=z["tri_verts"],
            tri_colors=z["tri_colors"],
            preprocessing_transform=z["preprocessing_transform"],
            symmetric=bool(z["symmetric"]),
            symmetry_mode=int(z["symmetry_mode"]),
            full_tri_verts=z["full_tri_verts"],
            search_resolution=float(z["search_resolution"]),
            num_original_triangles=int(z["num_original_triangles"]),
            backface_cullable=bool(z["backface_cullable"]))
    model = load_model(path, **kwargs)
    tmp = fname + f".tmp{os.getpid()}.npz"   # np.savez appends .npz itself
    np.savez_compressed(
        tmp,
        name=np.asarray(model.name),
        tri_verts=model.tri_verts,
        tri_colors=model.tri_colors,
        preprocessing_transform=model.preprocessing_transform,
        symmetric=np.asarray(model.symmetric),
        symmetry_mode=np.asarray(model.symmetry_mode),
        full_tri_verts=(model.full_tri_verts
                        if model.full_tri_verts is not None
                        else model.tri_verts),
        search_resolution=np.asarray(model.search_resolution),
        num_original_triangles=np.asarray(model.num_original_triangles),
        backface_cullable=np.asarray(model.backface_cullable))
    os.replace(tmp, fname)
    return model

"""PyTorch / CUDA port of perception_tpu for one NVIDIA H100.

The package mirrors `perception_tpu/`'s layout: `ops/` holds the batched
operators, each hand-written CUDA kernel beside its plain PyTorch twin
(`ops/raster_direct.py`, `ops/icp_fused.py`, `ops/cost_fused.py`,
`ops/cost_fused_color.py`, sources in `csrc/`, built by `kernels/build.py`);
`pipeline/` the scorer, environment and recogniser, and the search modes
(tree search, MHA*, successor pruning, detection heuristics); `serve.py` the
HTTP service. A kernel wrapper dispatches on the device of its tensors: CUDA
launches the kernel (or raises), CPU runs the twin. The host modules
(`core/` configs, poses, states, meshes; `io/` pose files and the model
cache; `utils/stats`) are the port's own copies: this package imports
neither jax nor the JAX package. Its entry points run on the card unless
given `device="cpu"`.
"""

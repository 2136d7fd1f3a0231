"""PyTorch / CUDA port of perception_tpu for one NVIDIA H100.

The package mirrors `perception_tpu/`'s layout: `ops/` holds the batched
operators, each hand-written CUDA kernel beside its plain PyTorch twin
(`ops/raster_direct.py`, `ops/icp_fused.py`, `ops/cost_fused.py`, sources in
`csrc/`, built by `kernels/build.py`); `pipeline/` the scorer, environment
and recogniser; `serve.py` the HTTP service. A kernel wrapper dispatches on
the device of its tensors: CUDA launches the kernel (or raises), CPU runs the
twin. The framework-free host modules of `perception_tpu` (configs, poses,
meshes, states, pose files) are reused by import; this package never imports
jax.
"""

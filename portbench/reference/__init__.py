"""The plain reference the benchmark holds the program's answers against.

Plain PyTorch and NumPy (SciPy for the k-d trees). It imports neither JAX
nor the JAX package nor anything of the program: it takes the benchmark's
own frames, meshes and candidate rows and works out again everything the
program's set-up derives from them.
"""

"""CPU tests of the benchmark (run with `python -m pytest portbench/tests`);
the card test skips without a CUDA card."""

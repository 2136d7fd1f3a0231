"""The benchmark of the PyTorch and CUDA port (`perception_tpu_torch`).

One run: `python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`. See README.md beside this file.
"""

"""The benchmark of the PyTorch and CUDA port (`perception_tpu_torch`).

One run: `python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`. See README.md beside this file.
"""

import importlib.util
import sys
from pathlib import Path


def load_file(path: Path, prefix: str):
    """The module in a file of the benchmark found by name (a metric's
    reader, a scene kind, a reference), registered as
    `<prefix>_<stem>` with dots made underscores."""
    path = Path(path)
    name = f"{prefix}_{path.stem.replace('.', '_').replace('-', '_')}"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod

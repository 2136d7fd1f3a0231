"""Process-group initialisation and each process's share of the poses.

Counterpart of `perception_tpu/parallel/dist.py`. The reference distributes
with Boost.MPI (a master broadcasting the model bank and the camera, slaves
scoring chunks); here every process runs the same program on
`torch.distributed`, builds the model bank and the observed scene itself
(inputs read from shared storage) and scores its chunk of the candidates
(`parallel/sharding.py`).

The backend is always the caller's choice: "nccl" for one rank per GPU,
"gloo" for CPU tensors or for ranks that share one card (NCCL refuses two
ranks on one device). Nothing here picks one.
"""

from __future__ import annotations

import os

import torch.distributed as dist

from perception_tpu_torch.parallel.sharding import PoseMesh, make_pose_mesh


def initialize_multihost(
    backend: str,
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    init_method: str | None = None,
) -> None:
    """`torch.distributed.init_process_group` with the JAX version's
    environment fallbacks: PT_NUM_PROCESSES (default 1), PT_COORDINATOR
    (host:port of rank 0, default localhost:12345) and PT_PROCESS_ID
    (default 0). A no-op for one process. `init_method` (e.g.
    "file:///shared/dir/rendezvous") replaces the tcp:// rendezvous at the
    coordinator."""
    if num_processes is None:
        num_processes = int(os.environ.get("PT_NUM_PROCESSES", "1"))
    if num_processes <= 1:
        return
    if process_id is None:
        process_id = int(os.environ.get("PT_PROCESS_ID", "0"))
    if init_method is None:
        address = (coordinator_address
                   or os.environ.get("PT_COORDINATOR", "localhost:12345"))
        init_method = f"tcp://{address}"
    dist.init_process_group(backend=backend, init_method=init_method,
                            world_size=num_processes, rank=process_id)


def make_global_pose_mesh(device="cuda") -> PoseMesh:
    """The pose mesh over every process of the world group (this process
    alone without torch.distributed), scoring on `device`."""
    return make_pose_mesh(device)


def local_pose_slice(n_poses: int) -> tuple[int, int]:
    """[start, end) of the candidates this process materialises when
    inputs are generated process-locally: equal chunks by the world group's
    rank and size, the last ones short or empty (the reference's MPI
    scatter with dummy padding)."""
    if dist.is_available() and dist.is_initialized():
        pcount, pid = dist.get_world_size(), dist.get_rank()
    else:
        pcount, pid = 1, 0
    per = -(-n_poses // pcount)
    return pid * per, min((pid + 1) * per, n_poses)

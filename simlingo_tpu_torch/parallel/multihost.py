"""Multi-process start-up: one process per rank over torch.distributed.

Counterpart of `simlingo_tpu/parallel/multihost.py`. JAX starts
`jax.distributed` once per host; the port starts one process per rank (one
per GPU under `torchrun` or SLURM) and joins them into one default process
group, after which `parallel/mesh.py` lays the dp x fsdp x tp mesh over
the ranks.

`initialize` resolves its arguments in this order: explicit arguments;
torchrun's MASTER_ADDR / MASTER_PORT / WORLD_SIZE / RANK / LOCAL_RANK;
SLURM's SLURM_NTASKS / SLURM_PROCID / SLURM_LOCALID with the first host of
`scontrol show hostnames $SLURM_JOB_NODELIST` as the coordinator (port
12345, as JAX's :49-56). One process and no coordinator address is a
no-op that returns False. Otherwise it calls `init_process_group`: NCCL
whenever the device is the GPU, one process a GPU; gloo where the caller
asks for the CPU or names it (`backend="gloo"`: several ranks sharing one
GPU, which NCCL refuses). An NCCL start-up that fails raises. On the GPU
it first makes GPU `LOCAL_RANK % device_count` the process's current
device.

    python3 -m torch.distributed.run --nproc-per-node 8 train_torch.py mesh.fsdp=2 ...
    srun --ntasks-per-node 8 --gpus-per-node 8 python3 train_torch.py ...
"""

from __future__ import annotations

import os
import subprocess
from typing import Optional

import torch
import torch.distributed as dist

SLURM_PORT = 12345


def _env_int(*names) -> Optional[int]:
    for name in names:
        if os.environ.get(name, "") != "":
            return int(os.environ[name])
    return None


def resolve(coordinator_address: Optional[str] = None,
            num_processes: Optional[int] = None,
            process_id: Optional[int] = None,
            local_rank: Optional[int] = None):
    """(coordinator "host:port" or None, world, rank, local rank) from the
    arguments, then torchrun's variables, then SLURM's."""
    if num_processes is None:
        num_processes = _env_int("WORLD_SIZE", "SLURM_NTASKS")
    if process_id is None:
        process_id = _env_int("RANK", "SLURM_PROCID")
    if local_rank is None:
        local_rank = _env_int("LOCAL_RANK", "SLURM_LOCALID")
    if coordinator_address is None and "MASTER_ADDR" in os.environ:
        coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                               f"{os.environ.get('MASTER_PORT', '29500')}")
    if (coordinator_address is None and (num_processes or 1) > 1
            and "SLURM_JOB_NODELIST" in os.environ):
        first = subprocess.run(["scontrol", "show", "hostnames",
                                os.environ["SLURM_JOB_NODELIST"]],
                               capture_output=True, text=True,
                               check=True).stdout.split()[0]
        coordinator_address = f"{first}:{SLURM_PORT}"
    world = num_processes or 1
    rank = process_id or 0
    return coordinator_address, world, rank, rank if local_rank is None else local_rank


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               device="cuda", backend: Optional[str] = None,
               local_rank: Optional[int] = None) -> bool:
    """Join this process to the job's default process group. Returns True
    when a group is active (this call made it or one existed)."""
    if dist.is_initialized():
        return True
    addr, world, rank, local = resolve(coordinator_address, num_processes,
                                       process_id, local_rank)
    if world == 1 and addr is None:
        return False
    if addr is None:
        raise ValueError(f"{world} processes but no coordinator address (pass one, or "
                         "set MASTER_ADDR / run under SLURM)")
    dev = torch.device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("the NCCL backend needs device='cuda'")
    kw = {}
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device='cuda' requested but no CUDA GPU is available; "
                               "pass device='cpu' (gloo)")
        torch.cuda.set_device(local % torch.cuda.device_count())
        if backend == "nccl":
            kw["device_id"] = torch.device("cuda", torch.cuda.current_device())
    dist.init_process_group(backend, init_method=f"tcp://{addr}", world_size=world,
                            rank=rank, **kw)
    return True


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_primary() -> bool:
    return rank() == 0


def sync_hosts() -> None:
    """A barrier over every rank (no-op in one process)."""
    if dist.is_initialized():
        dist.barrier()


def shutdown() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()

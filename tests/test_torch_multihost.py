"""parallel/multihost.py, the counterpart of tests/test_multihost.py: the
one-process no-op, torchrun's and SLURM's variables (scontrol stubbed),
the backend on two 8-GPU nodes (the GPUs stubbed), and two gloo ranks (tests/torch_ranks.py) with a global sum, is_primary and
put_batch's slices assembling the global batch."""

import os
import stat

import numpy as np
import pytest

from simlingo_tpu_torch.parallel import multihost
from tests import torch_ranks as R

ENV = ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT", "LOCAL_WORLD_SIZE",
       "SLURM_NTASKS", "SLURM_PROCID", "SLURM_LOCALID", "SLURM_JOB_NODELIST")


@pytest.fixture
def clean_env(monkeypatch):
    for var in ENV:
        monkeypatch.delenv(var, raising=False)
    return monkeypatch


def test_initialize_single_process_noop(clean_env):
    assert multihost.initialize(device="cpu") is False
    assert multihost.is_primary() and multihost.world_size() == 1
    multihost.sync_hosts()          # no-op, must not raise
    assert multihost.resolve() == (None, 1, 0, 0)


def test_torchrun_variables(clean_env):
    for k, v in dict(WORLD_SIZE="8", RANK="5", LOCAL_RANK="1", MASTER_ADDR="node0",
                     MASTER_PORT="29511").items():
        clean_env.setenv(k, v)
    assert multihost.resolve() == ("node0:29511", 8, 5, 1)
    # explicit arguments come first
    assert multihost.resolve("h:1", 2, 0, 0) == ("h:1", 2, 0, 0)


def test_slurm_variables(clean_env, tmp_path):
    _fake_slurm(clean_env, tmp_path)
    assert multihost.resolve() == (f"gpu-a17:{multihost.SLURM_PORT}", 16, 9, 1)
    with pytest.raises(ValueError, match="NCCL"):
        multihost.initialize(device="cpu", backend="nccl")


def _fake_slurm(env, tmp_path):
    fake = tmp_path / "scontrol"
    fake.write_text("#!/bin/sh\n[ \"$1 $2\" = \"show hostnames\" ] && "
                    "printf 'gpu-a17\\ngpu-a18\\n'\n")
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    env.setenv("PATH", f"{tmp_path}{os.pathsep}{os.environ['PATH']}")
    for k, v in dict(SLURM_NTASKS="16", SLURM_PROCID="9", SLURM_LOCALID="1",
                     SLURM_JOB_NODELIST="gpu-a[17-18]").items():
        env.setenv(k, v)


@pytest.mark.parametrize("backend", [None, "gloo"])
def test_backend_on_two_8_gpu_nodes(clean_env, tmp_path, backend):
    """16 SLURM tasks on two 8-GPU nodes: NCCL on the GPU, whatever the task
    count; gloo only where the caller names it. The GPUs are stubbed."""
    _fake_slurm(clean_env, tmp_path)
    calls, current = [], []
    clean_env.setattr(multihost.torch.cuda, "is_available", lambda: True)
    clean_env.setattr(multihost.torch.cuda, "device_count", lambda: 8)
    clean_env.setattr(multihost.torch.cuda, "set_device", current.append)
    clean_env.setattr(multihost.torch.cuda, "current_device", lambda: current[-1])
    clean_env.setattr(multihost.dist, "init_process_group",
                      lambda *a, **kw: calls.append((a, kw)))
    assert multihost.initialize(device="cuda", backend=backend) is True
    (args, kw), = calls
    assert current == [1]
    assert kw["init_method"] == f"tcp://gpu-a17:{multihost.SLURM_PORT}"
    assert (kw["world_size"], kw["rank"]) == (16, 9)
    if backend is None:
        assert args == ("nccl",) and kw["device_id"] == multihost.torch.device("cuda", 1)
    else:
        assert args == ("gloo",) and "device_id" not in kw


def test_two_process_gloo_smoke(tmp_path):
    R.spawn(2, "hello", str(tmp_path))
    z = [np.load(tmp_path / f"hello{r}.npz") for r in range(2)]
    for r in range(2):
        np.testing.assert_array_equal(z[r]["sum"], [3.0, 3.0, 3.0])     # 1 + 2
        assert bool(z[r]["primary"]) == (r == 0)
        assert tuple(z[r]["coords"]) == (r, 0, 0)                      # dp = -1 fills
        np.testing.assert_array_equal(z[r]["local"], np.arange(16.0).reshape(8, 2)[4 * r:4 * r + 4])
        assert float(z[r]["meta"]) == 7.0                              # 0-d: replicated
        np.testing.assert_array_equal(z[r]["assembled"], np.arange(16.0).reshape(8, 2))

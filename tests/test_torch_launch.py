"""reductive_tpu_torch.parallel.launch and make_mesh, in this process.

``initialize_distributed`` refuses to go on single-process when a launcher
says that this process is one of several and the group cannot be joined
(tests/test_parallel.py holds the JAX package's counterpart); with no
launcher it sets up a one-process group, once; explicit arguments that fail
raise.  Every test leaves no process group behind.
"""

import datetime
import logging

import pytest
import torch.distributed as dist

from reductive_tpu_torch.parallel import launch, make_mesh
from torch_port_util import free_port

SHORT = datetime.timedelta(seconds=2)


@pytest.fixture
def clean(monkeypatch):
    """No launcher environment, no group before, none after."""
    for name in launch._MULTIPROCESS_ENV_SIGNALS + ("RANK", "LOCAL_RANK", "MASTER_PORT"):
        monkeypatch.delenv(name, raising=False)
    assert not dist.is_initialized()
    yield monkeypatch
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.mark.parametrize("signal,env", [
    ("MASTER_ADDR", {"MASTER_ADDR": "127.0.0.1", "WORLD_SIZE": "2", "RANK": "1"}),
    ("WORLD_SIZE", {"WORLD_SIZE": "2", "RANK": "1"}),
    ("SLURM_NTASKS", {"SLURM_NTASKS": "4"}),
    ("OMPI_COMM_WORLD_SIZE", {"OMPI_COMM_WORLD_SIZE": "2"}),
    ("TORCHELASTIC_RUN_ID", {"TORCHELASTIC_RUN_ID": "job"}),
])
def test_refuses_a_single_process_fallback_when_the_launcher_says_several(clean, signal, env):
    for name, value in env.items():
        clean.setenv(name, value)
    clean.setenv("MASTER_PORT", str(free_port()))  # nobody listens there
    with pytest.raises(RuntimeError, match=f"several processes \\({signal} is set\\)"):
        launch.initialize_distributed(timeout=SHORT)
    assert not dist.is_initialized()


@pytest.mark.parametrize("env", [{"WORLD_SIZE": "1"}, {"SLURM_NTASKS": "1"}, {"MASTER_ADDR": "h"}])
def test_signals_of_one_process_do_not_refuse(clean, caplog, env):
    for name, value in env.items():
        clean.setenv(name, value)
    with caplog.at_level(logging.WARNING, logger="reductive_tpu"):
        launch.initialize_distributed()
    assert "continuing single-process" in caplog.text
    assert dist.get_world_size() == 1 and dist.get_rank() == 0


def test_without_a_launcher_a_one_process_group_once(clean):
    launch.initialize_distributed()
    group = dist.group.WORLD
    assert dist.get_world_size() == 1 and dist.get_backend() == "gloo"
    launch.initialize_distributed()  # idempotent
    assert dist.group.WORLD is group
    mesh = make_mesh(devices="cpu")
    assert mesh.mesh_dim_names == ("data",) and tuple(mesh.shape) == (1,)


def test_explicit_arguments_that_fail_raise(clean):
    with pytest.raises(RuntimeError):
        launch.initialize_distributed(f"127.0.0.1:{free_port()}", 2, 1, timeout=SHORT)
    assert not dist.is_initialized()


def test_explicit_arguments_join_a_group(clean):
    launch.initialize_distributed(f"127.0.0.1:{free_port()}", 1, 0)
    assert dist.get_world_size() == 1 and dist.get_backend() == "gloo"
    mesh = make_mesh((1, -1), ("data", "model"), devices="cpu")
    assert tuple(mesh.shape) == (1, 1)


def test_make_mesh_needs_a_process_group(clean):
    with pytest.raises(RuntimeError, match="initialize_distributed"):
        make_mesh(devices="cpu")

"""The port's entry points run on the card unless the caller asks for the
CPU: called without a device where CUDA is absent, each raises and returns
no CPU tensors. CUDA's absence is simulated, so the tests mean the same on
a machine with a card."""

import numpy as np
import pytest
import torch

from elphdynamics_tpu_torch import bench, convert, simulation
from elphdynamics_tpu_torch.dynamics import hmc
from elphdynamics_tpu_torch.lattice import Lattice, UnitCell
from elphdynamics_tpu_torch.models.holstein import build_holstein
from elphdynamics_tpu_torch.models.ssh import build_ssh
from elphdynamics_tpu_torch.ops import deflation
from elphdynamics_tpu_torch.parallel import multihost
from elphdynamics_tpu_torch.utils.device import require_device

torch.set_num_threads(1)


def _lattice():
    return Lattice.create(UnitCell.create(2, 1, [[1.0, 0.0], [0.0, 1.0]], [[0.0, 0.0]]), 2)


ENTRY_POINTS = {
    "bench.build": lambda tmp: bench.build(bench.BENCH_8X8),
    "bench.build_bench_step": lambda tmp: bench.build_bench_step(2, 1.0, 0.1, 0.05, 1),
    "build_holstein": lambda tmp: build_holstein(
        _lattice(), 1.0, 0.1, t_assignments=[(1.0, 0.0, 0, 0, (1, 0, 0))]),
    "build_ssh": lambda tmp: build_ssh(
        _lattice(), 1.0, 0.1, hoppings=[dict(t=1.0, omega=1.0, alpha=0.2, o1=0, o2=0,
                                             dL=(1, 0, 0))]),
    "bench.build_ssh_step": lambda tmp: bench.build_ssh_step(2, 1.0, 0.1, 0.05, 1),
    "bench.build(SSH_64X64)": lambda tmp: bench.build(bench.SSH_64X64),
    "bench.build_langevin_step": lambda tmp: bench.build_langevin_step(2, 1.0, 0.1, 1e-3, 1),
    "bench.build(LANGEVIN_64X64)": lambda tmp: bench.build(bench.LANGEVIN_64X64),
    "bench.build(SSH_LANGEVIN_64X64)": lambda tmp: bench.build(bench.SSH_LANGEVIN_64X64),
    "simulation.load_model": lambda tmp: simulation.load_model(str(tmp)),
    "convert.params_from_jax": lambda tmp: convert.params_from_jax(
        {"mu": np.zeros(4), "omega": np.ones(4)}),
    "bench.build(KERNEL_2MN_64X64)": lambda tmp: bench.build(bench.KERNEL_2MN_64X64),
    "bench.build(TEMPERING_64X64)": lambda tmp: bench.build(bench.TEMPERING_64X64),
    "bench.build_deep_beta_solves": lambda tmp: bench.build_deep_beta_solves(),
    "deflation.init": lambda tmp: deflation.init(2, 4, 4, 10),
    "hmc.dt_tuner_init": lambda tmp: hmc.dt_tuner_init(0.05),
    "hmc.DtTunerState.from_list": lambda tmp: hmc.DtTunerState.from_list([0.0] * 7),
    "multihost.launch": lambda tmp: multihost.launch(print, 2, "gloo"),
}


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("name", list(ENTRY_POINTS))
def test_entry_point_defaults_to_the_card(no_cuda, name, tmp_path):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ENTRY_POINTS[name](tmp_path)


def test_require_device(no_cuda):
    assert require_device("cpu") == torch.device("cpu")
    with pytest.raises(RuntimeError):
        require_device()
    with pytest.raises(RuntimeError):
        require_device(torch.device("cuda", 0))

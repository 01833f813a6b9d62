"""The run's check for JAX compares top-level module names whole."""

import subprocess
import sys

from harness import spec
from harness.nojax import loaded_forbidden


def test_forbidden_names():
    assert loaded_forbidden({"jax": 0, "jax.numpy": 0}) == ["jax"]
    assert loaded_forbidden({"elphdynamics_tpu.models.holstein": 0}) == ["elphdynamics_tpu"]
    assert loaded_forbidden({"jaxlib.xla_client": 0, "flax": 0}) == ["flax", "jaxlib"]
    assert loaded_forbidden({"elphdynamics_tpu_torch": 0,
                             "elphdynamics_tpu_torch.ops.ckb_cuda": 0, "jaxtyping": 0}) == []


def test_harness_and_port_load_no_jax():
    code = ("import sys; sys.path[:0] = ['benchmark', '.']\n"
            "import harness.main, harness.control, elphdynamics_tpu_torch.bench\n"
            "from harness.nojax import loaded_forbidden\n"
            "print(loaded_forbidden())")
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"

"""The bond-pair correlations of the PyTorch port (BondBond,
CurrentCurrent, BondPairGreens; ``measure/intersite_corr.py``) against the
JAX package, float64 on the CPU.

Both packages analyse the same probes R and solutions M⁻¹R (the port's
solves, 2 chains, nᵥ = 4): every increment agrees to 1e-10, for a
two-orbital Holstein lattice with three bond definitions (9 bond pairs; at
L = 2 the periodic wrap drops duplicate bonds, at L = 3 it does not) and
for the square SSH model, whose current weights are the phonon-modulated
hoppings. ``process_bin`` (BondPairSusc included) agrees to 1e-10, and the
container shapes and output folders are the JAX package's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elphdynamics_tpu.io import output as jout
from elphdynamics_tpu.lattice import Lattice as JLattice
from elphdynamics_tpu.lattice import UnitCell as JUnitCell
from elphdynamics_tpu.measure import greens as jgreens
from elphdynamics_tpu.measure import measurements as jm
from elphdynamics_tpu.models import ssh as JS
from elphdynamics_tpu.models.adapter import make_model_ops as j_make_model_ops
from elphdynamics_tpu.models.holstein import build_holstein as j_build_holstein
from elphdynamics_tpu_torch.dynamics.solve import SolverConfig
from elphdynamics_tpu_torch.io import output as tout
from elphdynamics_tpu_torch.lattice import Lattice, UnitCell
from elphdynamics_tpu_torch.measure import greens as tgreens
from elphdynamics_tpu_torch.measure import intersite_corr as IC
from elphdynamics_tpu_torch.measure import measurements as tm
from elphdynamics_tpu_torch.models import ssh as TS
from elphdynamics_tpu_torch.models.adapter import make_model_ops
from elphdynamics_tpu_torch.models.holstein import build_holstein

torch.set_num_threads(1)

C, NV = 2, 4
KINDS = ("BondBond", "CurrentCurrent", "BondPairGreens")
UC2 = (2, 2, [[1.5, 0.8660254037844386], [1.5, -0.8660254037844386]], [[0.0, 0.0], [1.0, 0.0]])
HOLSTEIN = dict(t_assignments=[(1.0, 0.1, 0, 1, (0, 0, 0)), (0.8, 0.0, 1, 0, (1, 0, 0)),
                               (1.2, 0.0, 1, 0, (0, 1, 0))],
                omega=1.0, omega_std=0.1, lam=0.7, mu=-0.3, mu_std=0.1)
UC1 = (2, 1, [[1.0, 0.0], [0.0, 1.0]], [[0.0, 0.0]])
HOP = dict(t=1.0, t_std=0.1, alpha=0.3, alpha_std=0.05, omega=1.0, omega_std=0.1, o1=0, o2=0)
SSH_HOPS = [dict(HOP, dL=(1, 0, 0), name="x"), dict(HOP, dL=(0, 1, 0), name="y")]


def _models(name):
    if name == "ssh":
        js, jp = JS.build_ssh(JLattice.create(JUnitCell.create(*UC1), 4), 0.6, 0.1,
                              hoppings=SSH_HOPS, mu_assignments=[(-0.2, 0.1, None)],
                              rng=np.random.default_rng(3))
        ts, tp = TS.build_ssh(Lattice.create(UnitCell.create(*UC1), 4), 0.6, 0.1,
                              hoppings=SSH_HOPS, mu_assignments=[(-0.2, 0.1, None)],
                              rng=np.random.default_rng(3), device="cpu")
    else:
        L = int(name[-1])
        js, jp = j_build_holstein(JLattice.create(JUnitCell.create(*UC2), L), 0.6, 0.1,
                                  rng=np.random.default_rng(2), **HOLSTEIN)
        ts, tp = build_holstein(Lattice.create(UnitCell.create(*UC2), L), 0.6, 0.1,
                                rng=np.random.default_rng(2), device="cpu", **HOLSTEIN)
    return j_make_model_ops(js), jp, make_model_ops(ts), tp


def _spec(time_dependent, pairs=None):
    entries = tuple((k, time_dependent) + ((pairs,) if pairs else ()) for k in KINDS)
    return tm.MeasurementSpec(nv=NV, onsite_corr=(("Greens", True),), intersite_corr=entries)


@pytest.fixture(scope="module", params=["holstein_L2", "holstein_L3", "ssh"])
def analysed(request):
    """Both packages' increments from the same R and M⁻¹R, time dependent
    over all bond pairs and equal time over a chosen subset."""
    jops, jp, tops, tp = _models(request.param)
    rng = np.random.default_rng(7)
    x = 0.4 * rng.standard_normal((C, tops.Nph, tops.Ltau)) + 0.2
    if not tops.is_holstein:
        x = TS.tie_fields(tops.spec, torch.as_tensor(x)).numpy()
    tx = torch.as_tensor(x)
    R = torch.as_tensor(rng.standard_normal((C, NV, tops.Nsites, tops.Ltau)))
    gd = tgreens.sample_greens(tops, tp, tx, NV, SolverConfig(tol=1e-10, maxiter=3000), R=R)
    assert int(gd.flag.max()) == 0
    out = {}
    for label, mspec in (("time_dependent", _spec(True)),
                         ("equal_time", _spec(False, ((0, 1), (1, 1))))):
        inc, _, _ = tm.make_measurement_step(tops, mspec).analyze(tp, tx, gd)
        janalyze = jm.make_measurement_step(jops, mspec).analyze
        jinc = [janalyze(jp, jnp.asarray(x[c]), jgreens.GreensData(
            R=jnp.asarray(R[c].numpy()), MinvR=jnp.asarray(gd.MinvR[c].numpy()),
            iters=jnp.asarray(0), flag=jnp.asarray(0)))[0] for c in range(C)]
        out[label] = (mspec, inc, jinc)
    return jops, tops, out


@pytest.mark.parametrize("label", ["time_dependent", "equal_time"])
@pytest.mark.parametrize("kind", KINDS)
def test_intersite_increments_match_jax(analysed, kind, label):
    _, tops, out = analysed
    mspec, inc, jinc = out[label]
    ndefs = len(tops.spec.bond_defs)
    lat = tops.spec.lattice
    npairs = ndefs * ndefs if label == "time_dependent" else 2
    T = tops.Ltau + 1 if label == "time_dependent" else 1
    got = inc["intersite_corr"][kind]
    assert tuple(got.shape) == (C, npairs, lat.L1, lat.L2, lat.L3, T)
    assert got.dtype == torch.complex128
    for c in range(C):
        want = np.asarray(jinc[c]["intersite_corr"][kind])
        scale = max(np.abs(want).max(), 1.0)
        np.testing.assert_allclose(got[c].numpy(), want, rtol=0, atol=1e-10 * scale)
    assert float(got.abs().max()) > 0


def test_intersite_container_and_process_bin_match_jax(analysed):
    jops, tops, out = analysed
    mspec, inc, _ = out["time_dependent"]
    mean, _ = tm.mean_over_chains(inc, {}, torch.zeros(C, dtype=torch.int32))
    zero = tm.zero_container(tops, mspec, torch.float64, "cpu")
    jzero = jm.zero_container(jops, mspec)
    for group in zero:
        assert list(zero[group]) == list(jzero[group]), group
        for k, z in zero[group].items():
            assert tuple(z.shape) == jzero[group][k].shape == tuple(mean[group][k].shape)
    container = {g: {k: 3.0 * v for k, v in vals.items()} for g, vals in mean.items()}
    got = jax.tree.map(lambda t: t.numpy(), tm.process_bin(tops, mspec, container, 3))
    want = jm.process_bin(jops, mspec, jax.tree.map(lambda t: jnp.asarray(t.numpy()), container), 3)
    flat_got = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    flat_want = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    assert flat_got.keys() == flat_want.keys()
    assert "BondPairSusc" in got["intersite_susc"]
    for k in flat_got:
        np.testing.assert_allclose(flat_got[k], np.asarray(flat_want[k]), rtol=1e-10,
                                   atol=1e-10, err_msg=str(k))


def test_intersite_output_folders_match_jax(analysed, tmp_path):
    jops, tops, out = analysed
    mspec, inc, _ = out["time_dependent"]
    mean, _ = tm.mean_over_chains(inc, {}, torch.zeros(C, dtype=torch.int32))
    processed = jax.tree.map(lambda t: t.numpy(), tm.process_bin(tops, mspec, mean, 1))
    trees = {}
    for name, io, ops, zero in (
            ("torch", tout, tops, tm.zero_container(tops, mspec, torch.float64, "cpu")),
            ("jax", jout, jops, jm.zero_container(jops, mspec))):
        root = tmp_path / name
        io.init_measurement_folders(str(root), zero, ())
        io.write_key_files(str(root), ops, mspec, zero)
        io.write_bin(str(root), processed, 1, ops)
        trees[name] = {p.relative_to(root).as_posix(): p.read_bytes()
                       for p in root.rglob("*") if p.is_file()}
    assert trees["torch"].keys() == trees["jax"].keys()
    assert "BondPairSusc_momentum_f/BondPairSusc_momentum_00001.out" in trees["torch"]
    assert "CurrentCurrent_position_f/CurrentCurrent_position_key.out" in trees["torch"]
    for k in trees["torch"]:
        assert trees["torch"][k] == trees["jax"][k], k


def test_bond_fields_refuse_complex_probes():
    """Complex probes (complex hopping), refused until that was ported, are
    stored conjugated (the estimator pairs M⁻¹R with conj R); real probes
    are stored as they are."""
    _, _, tops, _ = _models("holstein_L2")
    g = torch.Generator().manual_seed(0)
    R = torch.randn((1, NV, tops.Nsites, tops.Ltau), dtype=torch.complex128, generator=g)
    bf = IC.BondFields(tops.spec.lattice, R, 2 * R, tgreens.pair_indices(NV), torch.complex128)
    assert bf.cplx
    torch.testing.assert_close(bf.r1, (bf.M1 / 2).conj(), rtol=0, atol=0)
    bf = IC.BondFields(tops.spec.lattice, R.real, 2 * R.real, tgreens.pair_indices(NV),
                       torch.complex128)
    assert not bf.cplx
    torch.testing.assert_close(bf.r1, bf.M1 / 2, rtol=0, atol=0)


def test_holstein_intersite_phonon_greens_is_refused():
    """Holstein's phonons sit on sites: its PhononGreens is on-site."""
    _, _, tops, _ = _models("holstein_L2")
    with pytest.raises(ValueError, match="on-site"):
        tm.make_measurement_step(tops, tm.MeasurementSpec(intersite_corr=(("PhononGreens", True),)))
    with pytest.raises(ValueError, match="unknown inter-site"):
        tm.make_measurement_step(tops, tm.MeasurementSpec(intersite_corr=(("BondCurrent", True),)))

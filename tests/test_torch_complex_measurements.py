"""The measurement stack and the driver under complex hopping (twisted
boundaries) in the PyTorch port, against the JAX package and against exact
Wick contractions.

Under the time-reversal-symmetric twist ensemble (spin ↓ on the conjugate
phases, G↓ = conj G↑) every correlation's spin sum reduces to real parts of
the complex spin-↑ estimates. Tested here, float64 on the CPU:

* the complex pair tensors (G, G↑, GG, GDD_G00, GDD_minus, G0D_GD0) on the
  same probes and solutions as the JAX package, to 1e-12;
* one measurement step per chain with the JAX package's circular complex
  probes (every on-site kind, BondBond, CurrentCurrent, BondPairGreens;
  twisted Holstein and twisted SSH), every increment to 1e-9, and
  ``process_bin`` to 1e-12;
* the port's estimators against exact Wick contractions of the dense twisted
  propagator: the Green's function and pair tensors, the on-site
  correlations, density, double occupancy and the bond kinetic energy, the
  inter-site BondBond and BondPairGreens (stochastic, with the JAX package's
  tolerances), and CurrentCurrent exactly (its expectation over the probes
  by basis-pair enumeration);
* the K-matrix file of twisted SSH byte for byte, and both stock twisted
  examples through the CLI (counts cut) writing the JAX driver's output
  tree.
"""

import copy
import dataclasses
import filecmp
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elphdynamics_tpu.dynamics.force import SolverConfig as JSolverConfig
from elphdynamics_tpu.io import config as jconfig
from elphdynamics_tpu.io import output as jout
from elphdynamics_tpu.lattice import Lattice as JLattice
from elphdynamics_tpu.lattice import UnitCell as JUnitCell
from elphdynamics_tpu.measure import greens as jgreens
from elphdynamics_tpu.measure import measurements as jm
from elphdynamics_tpu.models import holstein as JH
from elphdynamics_tpu.models import ssh as JS
from elphdynamics_tpu.models.adapter import make_model_ops as j_make_model_ops
from elphdynamics_tpu.simulation import simulate as jsimulate
from elphdynamics_tpu.utils import dtypes as jdtypes
from elphdynamics_tpu_torch import __main__ as cli
from elphdynamics_tpu_torch.dynamics.solve import SolverConfig
from elphdynamics_tpu_torch.io import config as tconfig
from elphdynamics_tpu_torch.io import output as tout
from elphdynamics_tpu_torch.io.output import dump_toml
from elphdynamics_tpu_torch.lattice import Lattice, UnitCell
from elphdynamics_tpu_torch.measure import greens as tgreens
from elphdynamics_tpu_torch.measure import intersite_corr as IC
from elphdynamics_tpu_torch.measure import measurements as tm
from elphdynamics_tpu_torch.models import holstein as TH
from elphdynamics_tpu_torch.models import ssh as TS
from elphdynamics_tpu_torch.models.adapter import make_model_ops
from elphdynamics_tpu_torch.simulation import load_model
from tests.dense_reference import dense_expK, dense_M

torch.set_num_threads(1)

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples")
CHAIN = (1, 1, [[1.0]], [[0.0]])
C, NV = 2, 4
ONSITE = tuple((k, True) for k in ("Greens", "DenDen", "SpinSpin", "PairGreens"))
BONDS = (("BondBond", True), ("CurrentCurrent", True), ("BondPairGreens", True))


def _T(a):
    return torch.as_tensor(np.array(a))


def _cnormal(rng, shape):
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


def _twisted_chain(L=4, Ltau=4, lam=0.5, mu=-0.2, twist=(2.4,), seed=0):
    """The twisted Holstein chain of the JAX package's measurement tests, in
    both packages, with a random phonon field."""
    kw = dict(t_assignments=[(1.0, 0.0, 0, 0, (1, 0, 0))], omega=1.0, lam=lam, mu=mu,
              twist=twist)
    js, jp = JH.build_holstein(JLattice.create(JUnitCell.create(*CHAIN), L), Ltau * 0.1, 0.1,
                               **kw)
    ts, tp = TH.build_holstein(Lattice.create(UnitCell.create(*CHAIN), L), Ltau * 0.1, 0.1,
                               device="cpu", **kw)
    x = 0.3 * np.random.default_rng(seed).standard_normal((ts.Nph, ts.Ltau))
    return js, jp, ts, tp, x


def _dense_minv(ts, tp, x):
    env = TH.expnV(ts, tp, _T(x)).numpy()
    expK = dense_expK(ts.Nsites, ts.ckb.neighbor_table, ts.ckb.groups, tp.cosht.numpy(),
                      tp.sinht.numpy())
    return np.linalg.inv(dense_M([expK @ np.diag(env[:, t]) for t in range(ts.Ltau)]))


def _ext(ts, Minv):
    """The antiperiodic extension of the spin-↑ propagator on the doubled τ
    axis, [N, 2L, N, 2L]."""
    N, L = ts.Nsites, ts.Ltau
    sgn = np.concatenate([np.ones(L), -np.ones(L)])
    idx = np.concatenate([np.arange(L)] * 2)
    return (sgn[None, :, None, None] * sgn[None, None, None, :]
            * Minv.reshape(N, L, N, L)[:, idx][:, :, :, idx])


# ---------------------------------------------------------------------------
# pair tensors
# ---------------------------------------------------------------------------

def test_complex_pair_tensors_match_jax():
    """Same complex probes and solutions: every pair tensor of the port is
    the JAX package's (G = Re G↑, G↑, GG, GDD_G00, GDD_minus, G0D_GD0)."""
    js, _, ts, _, _ = _twisted_chain(L=6)
    rng = np.random.default_rng(1)
    R, MR = _cnormal(rng, (5, ts.Nsites, ts.Ltau)), _cnormal(rng, (5, ts.Nsites, ts.Ltau))
    want = jgreens.pair_tensor_sums(js.lattice, jnp.asarray(R), jnp.asarray(MR))
    got = tgreens.pair_tensor_sums(ts.lattice, _T(R[None]), _T(MR[None]))
    assert got.n_pairs == want.n_pairs == 10
    for name in ("G", "G_up", "GG", "GDD_G00", "GDD_minus", "G0D_GD0"):
        np.testing.assert_allclose(getattr(got, name)[0].numpy(), np.asarray(getattr(want, name)),
                                   rtol=0, atol=1e-12, err_msg=name)
    real = tgreens.pair_tensor_sums(ts.lattice, _T(R.real[None]), _T(MR.real[None]))
    assert real.G_up is None and real.GDD_minus is None


def test_complex_pair_tensors_unbiased():
    """400 circular complex probes of a twisted chain: the port's G↑, GG,
    GDD_G00 and G0D_GD0 estimate their exact Wick values (the JAX package's
    tolerances); the twist makes G↑ genuinely complex."""
    _, _, ts, tp, x = _twisted_chain()
    Minv = _dense_minv(ts, tp, x)
    ext = _ext(ts, Minv)
    N, L, lat = ts.Nsites, ts.Ltau, ts.lattice
    V = 2 * L * lat.ncells
    G_up = np.zeros((lat.L1, 2 * L), dtype=complex)
    GG = np.zeros((lat.L1, 2 * L), dtype=complex)
    GDD = np.zeros((lat.L1, 2 * L))
    G0D = np.zeros((lat.L1, 2 * L))
    D = np.array([[ext[i, t, i, t] for t in range(2 * L)] for i in range(N)])
    for i in range(N):
        for dl in range(lat.L1):
            j = lat.site_to_site(i, (dl, 0, 0), 0)
            for t in range(2 * L):
                for t0 in range(2 * L):
                    g = ext[j, (t0 + t) % (2 * L), i, t0]
                    G_up[dl, t] += g / V
                    GG[dl, t] += g * np.conj(g) / V
                    a, b = D[j, (t0 + t) % (2 * L)], D[i, t0]
                    GDD[dl, t] += a.real * b.real / V
                    G0D[dl, t] += (g * ext[i, t0, j, (t0 + t) % (2 * L)]).real / V
    assert np.abs(G_up.imag).max() > 0.02
    ops = make_model_ops(ts)
    gd = tgreens.sample_greens(ops, tp, _T(x[None]), 400, SolverConfig(tol=1e-10, maxiter=3000),
                               generator=torch.Generator().manual_seed(0))
    assert gd.R.is_complex() and int(gd.flag.max()) == 0
    pt = tgreens.pair_tensor_sums(lat, gd.R, gd.MinvR)
    n = pt.n_pairs
    assert np.abs(pt.G_up[0, 0, 0, :, 0, 0].numpy() / n - G_up).max() < 0.05
    assert np.abs(pt.G[0, 0, 0, :, 0, 0].numpy() / n - G_up.real).max() < 0.05
    for got, want in ((pt.GG, GG), (pt.GDD_G00, GDD), (pt.G0D_GD0, G0D)):
        assert np.abs(got[0, 0, 0, :, 0, 0].numpy() / n - want).max() < 0.12


# ---------------------------------------------------------------------------
# the measurement step
# ---------------------------------------------------------------------------

def _models(name):
    if name == "ssh":
        kw = dict(hoppings=[dict(t=1.0, omega=1.0, alpha=0.3, o1=0, o2=0, dL=(1, 0, 0),
                                 name="ph")], mu_assignments=[(-0.2, 0.0, None)], twist=(0.9,))
        js, jp = JS.build_ssh(JLattice.create(JUnitCell.create(*CHAIN), 4), 0.6, 0.1,
                              rng=np.random.default_rng(0), **kw)
        ts, tp = TS.build_ssh(Lattice.create(UnitCell.create(*CHAIN), 4), 0.6, 0.1,
                              rng=np.random.default_rng(0), device="cpu", **kw)
        mspec = dict(nv=NV, onsite_corr=ONSITE, intersite_corr=BONDS + (("PhononGreens", True),))
    else:
        js, jp, ts, tp, _ = _twisted_chain(L=4, Ltau=6)
        mspec = dict(nv=NV, onsite_corr=ONSITE + (("PhononGreens", True),),
                     intersite_corr=BONDS)
    x = 0.3 * np.random.default_rng(7).standard_normal((C, ts.Nph, ts.Ltau))
    if name == "ssh":
        x = TS.tie_fields(ts, _T(x)).numpy()
    return (j_make_model_ops(js), jp, jm.MeasurementSpec(**mspec), make_model_ops(ts), tp,
            tm.MeasurementSpec(**mspec), x)


@pytest.mark.parametrize("name", ["holstein", "ssh"])
def test_complex_measurement_step_matches_jax(name):
    """One measurement per chain with the JAX package's circular complex
    probes: every increment and snapshot to 1e-9, the bin to 1e-12."""
    jops, jp, jspec, tops, tp, tspec, x = _models(name)
    keys = jax.random.split(jax.random.PRNGKey(5), C)
    jstep = jax.jit(jm.make_measurement_step(jops, jspec, JSolverConfig(tol=1e-10,
                                                                         maxiter=2000)))
    jres = [jstep(jp, jnp.asarray(x[c]), keys[c]) for c in range(C)]
    R = np.stack([np.asarray(jdtypes.trace_noise(jax.random.split(k)[1], jp,
                                                 (NV, tops.Nsites, tops.Ltau), jnp.float64))
                  for k in keys])
    assert np.iscomplexobj(R)
    tstep = tm.make_measurement_step(tops, tspec, SolverConfig(tol=1e-10, maxiter=2000))
    inc, stats, snaps = tstep(tp, _T(x), R=_T(R))
    for c, (jinc, jstats, _, _) in enumerate(jres):
        assert set(inc) == set(jinc)
        for group in inc:
            assert set(inc[group]) == set(jinc[group]), group
            for k, v in inc[group].items():
                np.testing.assert_allclose(v[c].numpy(), np.asarray(jinc[group][k]), rtol=1e-9,
                                           atol=1e-9, err_msg=f"{group}/{k}")
        assert int(stats["iters"][c]) == int(jstats["iters"])
        assert int(stats["flag"][c]) == int(jstats["flag"]) == 0
    mean, _ = tm.mean_over_chains(inc, snaps, stats["flag"])
    container = {g: {k: 3.0 * v for k, v in vals.items()} for g, vals in mean.items()}
    got = tm.process_bin(tops, tspec, container, 3)
    want = jm.process_bin(jops, jspec, jax.tree.map(lambda t: jnp.asarray(t.numpy()), container),
                          3)
    flat_got = {"/".join(map(str, p)): v for p, v in jax.tree_util.tree_flatten_with_path(
        jax.tree.map(lambda t: t.numpy(), got))[0]}
    flat_want = {"/".join(map(str, p)): v for p, v in
                 jax.tree_util.tree_flatten_with_path(want)[0]}
    assert flat_got.keys() == flat_want.keys()
    for k in flat_got:
        np.testing.assert_allclose(flat_got[k], np.asarray(flat_want[k]), rtol=1e-12,
                                   atol=1e-12, err_msg=k)


def _measure(ts, tp, x, mspec, sweeps, seed):
    """A bin of ``sweeps`` measurements of one field, processed."""
    ops = make_model_ops(ts)
    step = tm.make_measurement_step(ops, mspec, SolverConfig(tol=1e-10, maxiter=3000))
    gen = torch.Generator().manual_seed(seed)
    acc = tm.zero_container(ops, mspec, torch.float64, "cpu")
    for _ in range(sweeps):
        inc, stats, _ = step(tp, _T(x[None]), gen)
        assert int(stats["flag"].max()) == 0
        acc = {g: {k: v + inc[g][k][0] for k, v in vals.items()} for g, vals in acc.items()}
    return tm.process_bin(ops, mspec, acc, sweeps)


def test_complex_onsite_correlations_match_exact_wick():
    """DenDen, SpinSpin (with its twisted Im·Im direct term) and PairGreens
    of the port against exact Wick contractions with G↓ = conj G↑."""
    _, _, ts, tp, x = _twisted_chain()
    ext = _ext(ts, _dense_minv(ts, tp, x))
    N, L, lat = ts.Nsites, ts.Ltau, ts.lattice
    Vn = L * lat.ncells
    nn, zz = np.zeros((lat.L1, L)), np.zeros((lat.L1, L))
    pg = np.zeros((lat.L1, L), dtype=complex)
    for i in range(N):
        for dl in range(lat.L1):
            j = lat.site_to_site(i, (dl, 0, 0), 0)
            for t in range(L):
                for t0 in range(L):
                    ta = (t0 + t) % (2 * L)
                    g_ab, g_ba = ext[j, ta, i, t0], ext[i, t0, j, ta]
                    Da, Db = ext[j, ta, j, ta], ext[i, t0, i, t0]
                    contact = 1.0 if (j == i and ta == t0) else 0.0
                    exch = 2 * (g_ab * (contact - g_ba)).real
                    nn[dl, t] += ((2 - 2 * Da.real) * (2 - 2 * Db.real) + exch) / Vn
                    zz[dl, t] += (-4 * Da.imag * Db.imag + exch) / Vn
                    pg[dl, t] += g_ab * np.conj(g_ab) / Vn
    res = _measure(ts, tp, x, tm.MeasurementSpec(nv=60, onsite_corr=ONSITE[1:]), 12, 2)
    pos = {k: res["onsite_corr"][k]["position"][0][:, 0, 0, :L].numpy()
           for k in ("DenDen", "SpinSpin", "PairGreens")}
    assert np.abs(pos["DenDen"].real - nn).max() < 0.25
    assert np.abs(pos["SpinSpin"].real - zz).max() < 0.25
    assert np.abs(pos["PairGreens"] - pg).max() < 0.25
    assert np.isfinite(res["onsite_corr"]["DenDen"]["position"][0][:, 0, 0, L].numpy()).all()


def test_complex_scalars_and_el_ke_unbiased():
    """Density, double occupancy and the bond kinetic energy
    2·Re[t·G↑(1,2) + t̄·G↑(2,1)] of the twisted ensemble."""
    _, _, ts, tp, x = _twisted_chain()
    Minv = _dense_minv(ts, tp, x)
    N, L = ts.Nsites, ts.Ltau
    Gd = np.diagonal(Minv).reshape(N, L)
    density = float(np.mean(2.0 * (1.0 - Gd.real)))
    docc = float(np.mean(np.abs(1.0 - Gd) ** 2))
    M4 = Minv.reshape(N, L, N, L)
    s1 = ts.ckb.neighbor_table[0][ts.bond_to_ckb]
    s2 = ts.ckb.neighbor_table[1][ts.bond_to_ckb]
    t_b = tp.t.numpy()
    ke = sum(2 * np.real(t_b[b] * M4[s1[b], tt, s2[b], tt] + np.conj(t_b[b]) * M4[s2[b], tt,
                                                                                   s1[b], tt])
             for b in range(len(s1)) for tt in range(L)) / (ts.lattice.ncells * L)
    res = _measure(ts, tp, x, tm.MeasurementSpec(nv=100), 10, 3)
    assert abs(float(res["global"]["density"]) - density) < 0.06
    assert abs(float(res["onsite"]["density"][0]) - density) < 0.06
    assert abs(float(res["onsite"]["double_occ"][0]) - docc) < 0.08
    assert abs(float(res["intersite"]["el_ke"][0]) - ke) < 0.1
    assert abs(density - 1.0) > 0.02 and np.abs(Minv.imag).max() > 0.02


def test_complex_intersite_correlations_match_exact_wick():
    """BondBond and BondPairGreens of the twisted chain against exact Wick
    contractions (the bond's factors spin-summed, BondPairGreens' spin-↓
    factor the conjugate)."""
    _, _, ts, tp, x = _twisted_chain()
    ext = _ext(ts, _dense_minv(ts, tp, x))
    N, L, lat = ts.Nsites, ts.Ltau, ts.lattice
    _, _, rv = ts.bond_defs[0]
    Vn = L * lat.ncells
    bb = np.zeros((lat.L1, L))
    pg = np.zeros((lat.L1, L), dtype=complex)
    for i in range(N):
        ia = lat.site_to_site(i, rv, 0)
        for dl in range(lat.L1):
            j = lat.site_to_site(i, (dl, 0, 0), 0)
            ja = lat.site_to_site(j, rv, 0)
            for t in range(L):
                for t0 in range(L):
                    ta = (t0 + t) % (2 * L)
                    direct = (2 * ext[j, ta, ja, ta].real) * (2 * ext[i, t0, ia, t0].real)
                    contact = 1.0 if (ja == i and ta == t0) else 0.0
                    exch = 2 * (ext[j, ta, ia, t0] * (contact - ext[i, t0, ja, ta])).real
                    bb[dl, t] += (direct + exch) / Vn
                    pg[dl, t] += ext[ja, ta, ia, t0] * np.conj(ext[j, ta, i, t0]) / Vn
    res = _measure(ts, tp, x, tm.MeasurementSpec(nv=60, intersite_corr=(
        ("BondBond", True), ("BondPairGreens", True))), 12, 5)
    got_bb = res["intersite_corr"]["BondBond"]["position"][0][:, 0, 0, :L].numpy()
    got_pg = res["intersite_corr"]["BondPairGreens"]["position"][0][:, 0, 0, :L].numpy()
    assert np.abs(got_bb.real - bb).max() < 0.3
    assert np.abs(got_pg - pg).max() < 0.3


@pytest.mark.parametrize("twist", [2.4, 0.0], ids=["twisted", "untwisted"])
def test_currentcurrent_complex_exact_wick(twist):
    """CurrentCurrent's expectation over the probe pairs, computed exactly by
    enumerating basis pairs (every term is bilinear in each probe), equals
    the operator-level Wick contraction of the dense propagator (the JAX
    package's helper computes the Wick side), to machine precision; the
    twist changes the tensor."""
    from tests.test_intersite_corr import currentcurrent_expectation_vs_wick

    _, want = currentcurrent_expectation_vs_wick(twist)
    L, Lt = 4, 4
    ts, tp = TH.build_holstein(Lattice.create(UnitCell.create(*CHAIN), L), Lt * 0.1, 0.1,
                               t_assignments=[(1.0, 0.0, 0, 0, (1, 0, 0))], omega=1.0, lam=0.5,
                               mu=-0.2, twist=(twist,) if twist else None, device="cpu")
    x = 0.5 * np.random.default_rng(0).standard_normal((ts.Nph, Lt))
    Minv = _dense_minv(ts, tp, x).astype(complex)
    N = ts.Nsites
    NL = N * Lt
    cdt = torch.complex128
    basis = _T(np.eye(NL).reshape(NL, N, Lt)).to(cdt if twist else torch.float64)
    MinvB = Minv.T.reshape(NL, N, Lt)
    MB = _T(MinvB if twist else MinvB.real)
    ops = make_model_ops(ts)
    iu, ju = np.repeat(np.arange(NL), NL), np.tile(np.arange(NL), NL)
    n = NL * NL

    def cc(R, M, pairs):
        bf = IC.BondFields(ts.lattice, R[None], M[None], pairs, cdt)
        return IC.measure_currentcurrent(ops, tp, _T(x[None]), None, bf, [(0, 0)], True)[0, 0]

    acc = cc(torch.cat([basis[iu], basis[ju]]), torch.cat([MB[iu], MB[ju]]),
             (np.arange(n), np.arange(n) + n))
    zero = cc(torch.cat([basis, torch.zeros_like(basis)]), torch.cat([MB, torch.zeros_like(MB)]),
              (np.arange(NL), np.arange(NL) + NL))
    got = (acc - (NL - 1) * zero).real[:, 0, 0, :Lt].numpy()
    assert np.abs(got - want).max() < 1e-10
    if twist:
        assert np.abs(want - currentcurrent_expectation_vs_wick(0.0)[1]).max() > 1e-3


# ---------------------------------------------------------------------------
# files and the driver
# ---------------------------------------------------------------------------

def test_twisted_ssh_matrix_files_match_jax(tmp_path):
    """The twisted SSH K matrix ('col row real imag', Hermitian) byte for
    byte, and M of a twisted model to 1e-10."""
    cfg = jconfig.load_toml(os.path.join(EXAMPLES, "ssh_hmc_twisted.toml"))
    cfg["ssh"]["beta"] = 0.6
    js = jconfig.build_setup(copy.deepcopy(cfg), str(tmp_path))
    ts = tconfig.build_setup(copy.deepcopy(cfg), str(tmp_path), "cpu", torch.float64)
    assert ts.params.t_phase is not None
    x = np.asarray(JS.tie_fields(js.ops.spec, jnp.asarray(
        0.3 * np.random.default_rng(1).standard_normal((ts.ops.Nph, ts.ops.Ltau)))))
    jout.write_K_matrix(js.ops, js.params, jnp.asarray(x), str(tmp_path / "jK.out"), tau=2)
    tout.write_K_matrix(ts.ops, ts.params, _T(x), str(tmp_path / "tK.out"), tau=2)
    assert filecmp.cmp(tmp_path / "jK.out", tmp_path / "tK.out", shallow=False)
    assert (tmp_path / "tK.out").read_text().startswith("col row real imag\n")
    jout.write_M_matrix(js.ops, js.params, jnp.asarray(x), str(tmp_path / "jM.out"), chunk=32)
    tout.write_M_matrix(ts.ops, ts.params, _T(x), str(tmp_path / "tM.out"), chunk=32)
    jM, tM = (np.loadtxt(tmp_path / f, skiprows=1) for f in ("jM.out", "tM.out"))
    np.testing.assert_array_equal(jM[:, :2], tM[:, :2])
    np.testing.assert_allclose(jM[:, 2:], tM[:, 2:], atol=2e-10)
    assert np.abs(tM[:, 3]).max() > 1e-3


def _tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


@pytest.mark.parametrize("example", ["holstein_hmc_twisted", "ssh_hmc_twisted"])
def test_driver_runs_twisted_example(example, tmp_path, capsys):
    """``python -m elphdynamics_tpu_torch examples/<example>.toml --device
    cpu`` cut to L = 2, β = 1 and a few updates writes the output tree of
    the JAX package's driver on the same file, with finite bins, no solver
    failure and a summary carrying the complex hopping's imaginary part
    (Holstein) or the bond-phonon statistics (SSH)."""
    paths = {}
    for pkg in ("jax", "torch"):
        cfg = jconfig.load_toml(os.path.join(EXAMPLES, f"{example}.toml"))
        cfg["lattice"]["L"] = 2
        cfg["holstein" if "holstein" in cfg else "ssh"]["beta"] = 1.0
        cfg["hmc"].update(burnin_updates=1, simulation_updates=2, meas_freq=1)
        cfg["simulation"].update(num_bins=2, filepath=str(tmp_path / pkg), random_seed=3)
        cfg["measurements"]["num_random_vectors"] = 4
        cfg["solver"].setdefault("preconditioner", {})["max_order"] = 8
        (tmp_path / f"{pkg}_input").mkdir()
        paths[pkg] = tmp_path / f"{pkg}_input" / f"{example}.toml"
        paths[pkg].write_text(dump_toml(cfg))
    assert cli.main([str(paths["torch"]), "1", "--device", "cpu", "--x64", "--chains", "2"]) == 0
    capsys.readouterr()
    jsimulate(str(paths["jax"]), run_id=1, n_chains=2)
    folder = tmp_path / "torch" / f"{example}-1"
    names = _tree(folder)
    assert names == _tree(tmp_path / "jax" / f"{example}-1")
    for b in (1, 2):
        for name in ("Greens_position", "DenDen_momentum", "PairSusc_position"):
            data = np.loadtxt(folder / f"{name}_f" / f"{name}_{b:05d}.out", skiprows=1)
            assert data.size and np.isfinite(data).all(), name
    summary = (folder / f"{example}_summary.out").read_text()
    assert "Solver Failures" not in summary
    assert ("t_imag_avg" in summary) if "holstein" in example else ("sign_switch 1 = " in summary)
    setup, params, xs = load_model(str(folder), "cpu")
    assert dataclasses.is_dataclass(params) and torch.isfinite(xs).all()
    assert params.t_phase.is_complex() if "ssh" in example else params.sinht.is_complex()

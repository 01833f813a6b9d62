"""The checkerboard fold of the PyTorch port: the plain torch twin against
the JAX package's XLA fold and its Pallas kernel (interpret mode), with one
``[Nb]`` table, one ``[Nb]`` table per chain and one coefficient per chain,
bond and column, and the CUDA wrapper's CPU behaviour. The kernel itself is
tested on the card by tests/test_torch_kernels_cuda.py."""

import numpy as np
import pytest
import torch

from elphdynamics_tpu.lattice import Lattice as JLattice
from elphdynamics_tpu.lattice import UnitCell as JUnitCell
from elphdynamics_tpu.models.holstein import build_holstein as j_build_holstein
from elphdynamics_tpu.ops import checkerboard as jckb
from elphdynamics_tpu.ops import ckb_pallas
from elphdynamics_tpu_torch.lattice import Lattice as TLattice
from elphdynamics_tpu_torch.lattice import UnitCell as TUnitCell
from elphdynamics_tpu_torch.models.holstein import build_holstein as t_build_holstein
from elphdynamics_tpu_torch.ops import checkerboard as tckb
from elphdynamics_tpu_torch.ops import ckb_cuda

torch.set_num_threads(1)

# (name, reverse, sign, JAX XLA fold, port twin)
DIRECTIONS = [
    ("forward", False, 1.0, jckb.ckb_mul, tckb.ckb_mul),
    ("transpose", True, 1.0, jckb.ckb_transpose_mul, tckb.ckb_transpose_mul),
    ("inverse", True, -1.0, jckb.ckb_inverse_mul, tckb.ckb_inverse_mul),
    ("inverse_transpose", False, -1.0, jckb.ckb_inverse_transpose_mul,
     tckb.ckb_inverse_transpose_mul),
]
IDS = [d[0] for d in DIRECTIONS]


def _model(L=6):
    """The disordered 6×6 lattice of tests/test_checkerboard.py's Pallas
    test (non-uniform t on both bond families), built by both packages."""
    kw = dict(beta=1.0, dtau=0.1, omega=1.0, lam=0.5, mu=0.0, dense_threshold=0,
              t_assignments=[(1.0, 0.1, 0, 0, (1, 0, 0)), (0.8, 0.1, 0, 0, (0, 1, 0))])
    uc_args = (2, 1, [[1.0, 0.0], [0.0, 1.0]], [[0.0, 0.0]])
    spec, params = j_build_holstein(JLattice.create(JUnitCell.create(*uc_args), L),
                                    rng=np.random.default_rng(0), **kw)
    tspec, tparams = t_build_holstein(TLattice.create(TUnitCell.create(*uc_args), L),
                                      rng=np.random.default_rng(0), device="cpu", **kw)
    np.testing.assert_array_equal(tparams.cosht.numpy(), np.asarray(params.cosht))
    return spec, np.array(params.cosht), np.array(params.sinht), tspec.ckb


@pytest.fixture(scope="module")
def model():
    return _model()


@pytest.mark.parametrize("name,rev,sign,jfn,tfn", DIRECTIONS, ids=IDS)
@pytest.mark.parametrize("shape", [(16,), (3, 2, 5)], ids=["NK", "B2NK"])
def test_twin_matches_xla_fold(model, name, rev, sign, jfn, tfn, shape):
    spec, c, s, tspec = model
    N = spec.Nsites
    v = np.random.default_rng(1).standard_normal(shape[:-1] + (N, shape[-1]))
    want = np.asarray(jfn(spec.ckb, c, s, v))
    ct, st, vt = torch.as_tensor(c), torch.as_tensor(s), torch.as_tensor(v)
    np.testing.assert_allclose(tfn(tspec, ct, st, vt).numpy(), want, rtol=0, atol=1e-12)
    np.testing.assert_allclose(tckb.fold(tspec, ct, st, vt, reverse=rev, sign=sign).numpy(),
                               want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("name,rev,sign,jfn,tfn", DIRECTIONS, ids=IDS)
@pytest.mark.parametrize("shape", [(16,), (3, 2, 5)], ids=["NK", "B2NK"])
def test_twin_matches_pallas_interpret(model, name, rev, sign, jfn, tfn, shape):
    spec, c, s, tspec = model
    N = spec.Nsites
    v = np.random.default_rng(2).standard_normal(shape[:-1] + (N, shape[-1]))
    v2, restore = ckb_pallas._to_2d(v)
    want = np.asarray(restore(ckb_pallas.fold_2d(spec.ckb, c, s, v2, reverse=rev, sign=sign,
                                                 interpret=True)))
    got = ckb_cuda.fold(tspec, torch.as_tensor(c), torch.as_tensor(s), torch.as_tensor(v),
                        reverse=rev, sign=sign)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12)


def test_spec_rebuilt_from_lattice_inputs_matches(model):
    spec, _, _, tspec = model
    for f in ("partner", "bond_of_site", "mask", "neighbor_table", "groups"):
        np.testing.assert_array_equal(getattr(tspec, f), getattr(spec.ckb, f))


def test_cuda_wrapper_on_cpu_uses_twin_without_launching(model):
    """ckb_cuda imports and runs with no nvcc and no card: a CPU tensor goes
    to the plain twin and counts no launch."""
    _, c, s, tspec = model
    v = torch.as_tensor(np.random.default_rng(3).standard_normal((2, tspec.nsites, 4)))
    before, shapes = ckb_cuda.launches, dict(ckb_cuda.launch_shapes)
    for _, rev, sign, _, tfn in DIRECTIONS:
        got = ckb_cuda.fold(tspec, torch.as_tensor(c), torch.as_tensor(s), v, reverse=rev, sign=sign)
        assert torch.equal(got, tfn(tspec, torch.as_tensor(c), torch.as_tensor(s), v))
    assert ckb_cuda.launches == before and ckb_cuda.launch_shapes == shapes


def test_tile_choice():
    """The cluster and column-tile chooser on an H100 (227 KB opt-in shared
    memory, 132 SMs): two CTAs per SM, cs raised while the grid underfills
    the SMs, K tiled only where 16 slabs cannot hold a row."""
    smem, sms = 232448, 132
    half = (smem + ckb_cuda.CTA_RESERVE) // 2 - ckb_cuda.CTA_RESERVE
    # 64×64 float32: the fermion operator (256 CTAs) and the power
    # iteration (K = 1, raised to 8 ranks, not the 16 that fill the SMs);
    # float64 needs 16 ranks for its slabs
    assert ckb_cuda.choose_cluster(32, 4096, 40, 4, smem, sms) == (8, 40)
    assert ckb_cuda.choose_cluster(16, 4096, 40, 4, smem, sms) == (8, 40)
    assert ckb_cuda.choose_cluster(16, 4096, 1, 4, smem, sms) == (8, 1)
    assert ckb_cuda.choose_cluster(32, 4096, 40, 8, smem, sms) == (16, 40)
    # with the 64×64 plan's bond tables (1088 bonds on the busiest of 8
    # ranks) the fermion operator still takes two CTAs per SM at cs = 8
    g = ckb_cuda.geometry(160, 4096, 40, 4, smem, sms, owned=lambda cs: 8704 // cs)
    assert (g.cs, g.kt, g.vec, g.threads, g.owned) == (8, 40, 4, 510, 1088)
    assert ckb_cuda._cta_bytes(4096, 8, 40, 4, 1088) <= half
    # 128×128 float64: K is tiled in the largest cluster
    cs, kt = ckb_cuda.choose_cluster(32, 16384, 40, 8, smem, sms)
    assert cs == 16 and 1 <= kt < 40 and kt % 4 == 0
    assert ckb_cuda._cta_bytes(16384, cs, kt, 8) <= half
    for B, N, K, item in ((1, 64, 40, 4), (128, 4096, 40, 4), (3, 1000, 7, 8), (2, 36, 1, 4),
                          (1, 3, 5, 8), (4, 4096, 1000, 4)):
        g = ckb_cuda.geometry(B, N, K, item, smem, sms)
        assert 1 <= g.kt <= K and g.cs <= N and g.kt % g.vec == 0 and K % g.vec == 0
        assert ckb_cuda._cta_bytes(N, g.cs, g.kt, item) <= smem
        assert g.threads <= ckb_cuda.MAX_THREADS and g.threads % (g.kt // g.vec) == 0
    with pytest.raises(ValueError):
        ckb_cuda.choose_cluster(1, 10**6, 4, 8, smem, sms)


@pytest.mark.parametrize("B,N,K,item,sizes", [
    (32, 4096, 40, 4, {8, 16}),          # the fermion operator, float32
    (16, 4096, 1, 4, {2, 4, 8, 16}),     # the power iteration (1 rank: tables too large)
    (32, 4096, 40, 8, {16}),             # float64: only 16 ranks fit two CTAs per SM
    (32, 16384, 40, 8, {16}),            # 128×128 float64, K tiled
    (2, 36, 7, 8, {1, 2, 4, 8, 16}),     # 6×6, odd K
    (8, 4096, 160, 4, {16}),             # β = 16 (Lτ = 160), float32: K tiled
    (128, 4096, 160, 4, {16}),           # the deflation filter's 4 chains × 32 rows
    (8, 4096, 160, 8, {16}),             # β = 16, float64
])
def test_tuning_candidates(B, N, K, item, sizes):
    """The geometries a shape's first launch times: the chooser's first,
    every cluster size whose CTA fits two to an SM, about 256, 384 and 512
    threads in whole site rows, no duplicates, one column tile for all."""
    smem, sms = 232448, 132
    half = (smem + ckb_cuda.CTA_RESERVE) // 2 - ckb_cuda.CTA_RESERVE
    owned = lambda cs: 2 * N // cs  # noqa: E731  (a square lattice's 2N bonds, split evenly)
    cands = ckb_cuda.candidates(B, N, K, item, smem, sms, owned)
    first = ckb_cuda.geometry(B, N, K, item, smem, sms, owned)
    assert cands[0] == first
    assert len(set(cands)) == len(cands)
    assert {g.cs for g in cands} == sizes
    for g in cands:
        assert (g.B, g.N, g.K, g.kt, g.vec) == (B, N, K, first.kt, first.vec)
        assert g.owned == owned(g.cs) and g.cs <= N
        assert g.threads <= ckb_cuda.MAX_THREADS and g.threads % (g.kt // g.vec) == 0
        assert g.cs == first.cs or ckb_cuda._cta_bytes(N, g.cs, K, item, g.owned) <= half
    assert {g.threads for g in cands if g.cs == first.cs} >= {first.threads}
    if first.kt == K and K == 40 and item == 4:
        assert {g.threads for g in cands if g.cs == 16} == {250, 380, 510}


def test_tuning_candidates_per_column():
    """With per-column coefficients the bond tables hold plan entries only
    (16 bytes a bond, not 16 + 2 coefficients), so a CTA needs less shared
    memory and every candidate carries the mode (the geometry cache and the
    kernel's shared-memory size depend on it)."""
    smem, sms = 232448, 132
    owned = lambda cs: 2 * 4096 // cs  # noqa: E731
    for cs in (1, 8, 16):
        assert (ckb_cuda._cta_bytes(4096, cs, 40, 4, owned(cs), per_column=True)
                == ckb_cuda._cta_bytes(4096, cs, 40, 4, owned(cs)) - owned(cs) * 8)
    cands = ckb_cuda.candidates(16, 4096, 40, 4, smem, sms, owned, per_column=True)
    assert all(g.per_column for g in cands)
    assert cands[0] == ckb_cuda.geometry(16, 4096, 40, 4, smem, sms, owned, per_column=True)
    shared = ckb_cuda.candidates(16, 4096, 40, 4, smem, sms, owned)
    assert not any(g.per_column for g in shared)
    assert {g.cs for g in cands} >= {g.cs for g in shared}


def test_tuning_keeps_the_fastest():
    cands = ckb_cuda.candidates(32, 4096, 40, 4, 232448, 132)
    assert ckb_cuda.fastest(cands, [3.0, 1.0, 2.0] + [5.0] * (len(cands) - 3)) == cands[1]
    assert ckb_cuda.fastest(cands, [1.0] * len(cands)) == cands[0]   # ties keep the first


def _replay(plan, c, s, v, sign):
    """The plan run in plain torch on per-rank slabs, as the kernels run it:
    each rank updates the bonds it owns, reaching partners in other ranks'
    slabs."""
    slabs = [v[..., plan.site0[r]:plan.site0[r + 1], :].clone() for r in range(plan.cs)]
    for step in range(len(plan.steps)):
        for r in range(plan.cs):
            owned = torch.as_tensor(plan.owned(r, step).astype(np.int64))
            for q in range(plan.cs):
                li, lj, _, n = owned[owned[:, 2] == q].T
                cc, ss = c[n], sign * s[n]
                if c.ndim == 1:
                    cc, ss = cc[:, None], ss[:, None]
                vi, vj = slabs[r][..., li, :], slabs[q][..., lj, :]
                slabs[r][..., li, :] = cc * vi + ss * vj
                slabs[q][..., lj, :] = cc * vj + ss * vi
    return torch.cat(slabs, dim=-2)


@pytest.fixture(scope="module")
def model_64():
    uc = TUnitCell.create(2, 1, [[1.0, 0.0], [0.0, 1.0]], [[0.0, 0.0]])
    spec, params = t_build_holstein(
        TLattice.create(uc, 64), 1.0, 0.1, dense_threshold=0, rng=np.random.default_rng(4),
        t_assignments=[(1.0, 0.1, 0, 0, (1, 0, 0)), (0.8, 0.1, 0, 0, (0, 1, 0))], device="cpu")
    return spec.ckb, params.cosht, params.sinht


@pytest.mark.parametrize("cs", [1, 2, 8, 16])
@pytest.mark.parametrize("name,rev,sign,jfn,tfn", DIRECTIONS, ids=IDS)
@pytest.mark.parametrize("lattice", ["6x6", "64x64"])
def test_cluster_plan_replay_matches_twin(model, model_64, lattice, name, rev, sign, jfn,
                                          tfn, cs):
    """The cluster plan replayed on per-rank slabs is the fold (6×6: 36
    sites, not divisible by 8 or 16, so the ranks hold unequal counts)."""
    if lattice == "6x6":
        _, c, s, spec = model
        c, s = torch.as_tensor(c), torch.as_tensor(s)
    else:
        spec, c, s = model_64
    plan = ckb_cuda.cluster_plan(spec, cs, reverse=rev)
    bi, bj = spec.neighbor_table
    counts = np.diff(plan.site0)
    assert counts.sum() == spec.nsites and counts.max() - counts.min() <= 1
    # every bond once, owned by the rank holding its first endpoint
    assert sorted(plan.bonds[:, 3]) == list(range(spec.nbonds))
    assert plan.offsets[0, 0] == 0 and plan.offsets[-1, -1] == spec.nbonds
    for r in range(cs):
        for step, g in enumerate(plan.steps):
            e = plan.owned(r, step)
            assert (spec.groups[e[:, 3]] == g).all()
            np.testing.assert_array_equal(plan.site0[r] + e[:, 0], bi[e[:, 3]])
            np.testing.assert_array_equal(plan.site0[e[:, 2]] + e[:, 1], bj[e[:, 3]])
    ri = np.searchsorted(plan.site0, bi, side="right") - 1
    rj = np.searchsorted(plan.site0, bj, side="right") - 1
    for step, g in enumerate(plan.steps):
        assert plan.crosses[step] == (ri != rj)[spec.groups == g].any()
    v = torch.as_tensor(np.random.default_rng(6).standard_normal((2, spec.nsites, 3)))
    want = tckb.fold(spec, c, s, v, reverse=rev, sign=sign)
    got = _replay(plan, c, s, v, sign)
    assert ((got - want).abs().max() / want.abs().max()).item() <= 1e-12


def test_cluster_plan_refuses_more_ranks_than_sites(model):
    _, _, _, spec = model
    with pytest.raises(ValueError):
        ckb_cuda.cluster_plan(spec, spec.nsites + 1)


def test_other_devices_refused(model):
    _, c, s, tspec = model
    v = torch.zeros((tspec.nsites, 2), dtype=torch.float64, device="meta")
    with pytest.raises(ValueError):
        ckb_cuda.fold(tspec, torch.as_tensor(c), torch.as_tensor(s), v)


# ---------------------------------------------------------------------------
# per-chain [C, Nb] and per-(chain, bond, column) [C, Nb, K] tables
# ---------------------------------------------------------------------------

C_TABLES, INNER, K_TABLES = 3, 2, 5
FORMS = ["chain", "chain_column"]


def _chain_tables(c, s, form, seed):
    """Per-chain perturbations of the model's coefficients: ``[C, Nb]`` or
    ``[C, Nb, K]`` (cosh stays above 1, as for a real bond)."""
    rng = np.random.default_rng(seed)
    shape = (C_TABLES, c.size) + ((K_TABLES,) if form == "chain_column" else ())
    grow = (slice(None), slice(None)) + ((None,) if form == "chain_column" else ())
    cc = c[None][grow] * (1.0 + 0.1 * rng.uniform(size=shape))
    ss = s[None][grow] * (1.0 + 0.2 * rng.standard_normal(shape))
    return cc, ss


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("name,rev,sign,jfn,tfn", DIRECTIONS, ids=IDS)
def test_chain_tables_match_xla_fold(model, name, rev, sign, jfn, tfn, form):
    """Each chain's rows folded with its own table equal JAX's fold of that
    chain with its [Nb] (or [Nb, Lτ]-like [Nb, K]) coefficients."""
    spec, c, s, tspec = model
    cc, ss = _chain_tables(c, s, form, 7)
    v = np.random.default_rng(8).standard_normal((C_TABLES, INNER, spec.Nsites, K_TABLES))
    got = ckb_cuda.fold(tspec, torch.as_tensor(cc), torch.as_tensor(ss), torch.as_tensor(v),
                        reverse=rev, sign=sign).numpy()
    for ch in range(C_TABLES):
        want = np.asarray(jfn(spec.ckb, cc[ch], ss[ch], v[ch]))
        np.testing.assert_allclose(got[ch], want, rtol=0, atol=1e-12)
    # a [C, N, K] field (one row per chain) takes the same tables
    got3 = tckb.fold(tspec, torch.as_tensor(cc), torch.as_tensor(ss), torch.as_tensor(v[:, 0]),
                     reverse=rev, sign=sign).numpy()
    np.testing.assert_allclose(got3, got[:, 0], rtol=0, atol=1e-14)


@pytest.mark.parametrize("name,rev,sign,jfn,tfn", DIRECTIONS, ids=IDS)
def test_chain_tables_match_pallas_interpret(model, name, rev, sign, jfn, tfn):
    """[C, Nb] tables against the Pallas kernel (interpret mode) run chain by
    chain, as the JAX package runs it under vmap."""
    spec, c, s, tspec = model
    cc, ss = _chain_tables(c, s, "chain", 9)
    v = np.random.default_rng(10).standard_normal((C_TABLES, INNER, spec.Nsites, K_TABLES))
    got = ckb_cuda.fold(tspec, torch.as_tensor(cc), torch.as_tensor(ss), torch.as_tensor(v),
                        reverse=rev, sign=sign).numpy()
    for ch in range(C_TABLES):
        v2, restore = ckb_pallas._to_2d(v[ch])
        want = np.asarray(restore(ckb_pallas.fold_2d(spec.ckb, cc[ch], ss[ch], v2, reverse=rev,
                                                     sign=sign, interpret=True)))
        np.testing.assert_allclose(got[ch], want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("cs", [1, 8])
@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("name,rev,sign,jfn,tfn", DIRECTIONS, ids=IDS)
def test_cluster_plan_replay_with_chain_tables(model, name, rev, sign, jfn, tfn, form, cs):
    """The kernels' plan replayed chain by chain with that chain's table
    (per column where the tables are) is the fold with the tables."""
    spec, c, s, tspec = model
    cc, ss = (torch.as_tensor(t) for t in _chain_tables(c, s, form, 11))
    plan = ckb_cuda.cluster_plan(tspec, cs, reverse=rev)
    v = torch.as_tensor(np.random.default_rng(12).standard_normal(
        (C_TABLES, INNER, spec.Nsites, K_TABLES)))
    want = tckb.fold(tspec, cc, ss, v, reverse=rev, sign=sign)
    got = torch.stack([_replay(plan, cc[ch], ss[ch], v[ch], sign) for ch in range(C_TABLES)])
    assert ((got - want).abs().max() / want.abs().max()).item() <= 1e-12


@pytest.mark.parametrize("shape", [(4, 72), (3, 71), (3, 72, 4), (3, 72, 5, 1), (72,)],
                         ids=["other_C", "other_Nb", "other_K", "rank4", "field_2d_chain"])
def test_fold_refuses_other_table_forms(model, shape):
    """The twin (and so the kernel wrapper's check) takes [Nb], [C, Nb] and
    [C, Nb, K] tables for a [C, ..., N, K] field and nothing else."""
    _, c, s, tspec = model
    assert tspec.nbonds == 72
    v = torch.zeros((3, 2, tspec.nsites, 5), dtype=torch.float64)
    if shape == (72,):            # [C, Nb] on an [N, K] field has no chain axis
        v, shape = v[0, 0], (3, 72)
    t = torch.ones(shape, dtype=torch.float64)
    with pytest.raises(ValueError):
        ckb_cuda.fold(tspec, t, t, v)
    with pytest.raises(ValueError):
        tckb.fold(tspec, torch.ones((3, 72), dtype=torch.float64),
                  torch.ones((3, 72, 5), dtype=torch.float64), v.expand(3, 2, -1, -1))

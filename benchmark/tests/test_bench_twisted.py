"""The twisted-boundary cell ``holstein_64_twisted.hmc_complex``: its files
found by name, the complex reference against the port's CPU path, the
control and the faults caught, its readers on records built by hand, and
the complex counts against brute counts."""

import copy
import math
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from counts import complex_ops
from harness import device as dev
from harness import spec
from harness.control import Control, faulty
from harness.main import run_cell
from harness.traffic import WINDOW, Traffic
from reference.models import Model
from reference.twisted import TwistedModel

from elphdynamics_tpu_torch.ops import ckb_cuda, kpm
from elphdynamics_tpu_torch.utils import spans

CELL = "holstein_64_twisted.hmc_complex"
TINY = {"lattice.L": 4, "holstein.beta": 1.0, "chains": 4}
NEW = ("acceptance.hmc_complex", "cg_iters_per_solve.hmc_complex", "update_mfu.hmc_complex",
       "k1_complex_roofline.hmc_complex", "cheb_steps_per_update.hmc_complex",
       "kpm_cheb_s.hmc_complex")
SHARED = ("host_reads_per_update.hmc", "idle_share.hmc", "launch_s.hmc", "read_wait_s.hmc",
          "solve_s.hmc", "kpm_apply_s.hmc", "kpm_setup_s.hmc", "force_s.hmc")


def test_cell_files_found_by_name():
    bench = spec.load_benchmark()
    cell = spec.find_cell(bench, CELL)
    assert (cell.config, cell.traffic, cell.chips) == ("holstein_64_twisted", "hmc_complex", 1)
    cfg = spec.load_config(cell.config)
    h = cfg.run["holstein"]
    assert cfg.run["lattice"]["L"] == 64 and cfg.chains == 32 and h["beta"] == 4.0
    assert h["twist"] == [math.pi / 4, math.pi / 8]
    assert "max_order" not in cfg.run["solver"]["preconditioner"]
    mix = spec.load_json("mixes", cell.traffic)
    assert mix["entry"] == "hmc" and mix["parts"] == ["complex_update"]
    part = spec.load_module("parts", "complex_update")
    assert part.NUMBERS == ("dH_gap", "state_gap", "accept_flips")
    assert set(mix) >= {"initial_field_seed", "warmup_steps", "trace_steps"}
    assert (spec.HERE / "limits" / f"{CELL}.json").is_file()
    assert [m["name"] for m in cell.end_to_end] == ["sweeps_per_s", "setup_s"]
    assert {m["name"] for m in cell.per_layer} == set(NEW) | set(SHARED)
    for m in cell.per_layer:
        assert callable(spec.load_reader(m["name"]).read)
        assert "fused" not in m["name"] and "k2" not in m["name"]


def test_draws_pack_the_spins_as_the_port():
    from elphdynamics_tpu_torch.utils.dtypes import pseudofermion_noise

    part = spec.load_module("parts", "complex_update")
    cfg = spec.load_config("holstein_64_twisted", overrides=TINY)
    model = Model(cfg.run, "cpu", torch.float64)
    traffic = Traffic(2 ** 36 + 1, model, 3, "cpu", torch.float32)
    d = part.draws(traffic, WINDOW, 4)
    assert d.pseudofermion.shape == (3, 1, model.N, model.Lt)
    assert d.pseudofermion.dtype == torch.complex64
    g = traffic.generator(WINDOW, 4)
    torch.randn((3, model.Nph, model.Lt), generator=g)
    want = pseudofermion_noise((3, model.N, model.Lt), torch.complex64, "cpu", g)
    assert torch.equal(d.pseudofermion, want)


def test_reference_hopping_is_the_ports():
    """exp(−Δτ·K) of the reference's phases equals the port's at 4×4 and
    6×6, and its reversed fold is the adjoint."""
    from elphdynamics_tpu_torch.io.config import build_setup
    from elphdynamics_tpu_torch.ops import checkerboard as ckb

    for L in (4, 6):
        cfg = spec.load_config("holstein_64_twisted", overrides={"lattice.L": L})
        m = TwistedModel(copy.deepcopy(cfg.run), "cpu")
        setup = build_setup(copy.deepcopy(cfg.run), "", "cpu", torch.float64)
        eye = torch.eye(m.N, dtype=torch.complex128)[None, None]
        co = m.coeffs(m.hopping(None))
        p = setup.params
        theirs = ckb.fold(setup.ops.spec.ckb, p.cosht, p.sinht, eye)
        assert torch.allclose(m.fold(co, eye), theirs, rtol=0, atol=1e-14)
        assert torch.allclose(m.fold(co, eye, transpose=True), theirs.mH, rtol=0, atol=1e-14)
        # a winding along a row collects θ₁·(L − 2)/L, as the model defines
        loop = np.prod([theirs[0, 0, i, (i + 1) % L].item() for i in range(L)])
        assert np.angle(loop) == pytest.approx(math.pi / 4 * (L - 2) / L, abs=1e-12)


def test_program_is_correct():
    r = run_cell(CELL, 2 ** 35 + 1, 0.0, False, "cpu", overrides=TINY)
    assert r["correct"], r["checks"]


@pytest.mark.parametrize("broken", ["control", "unchanged", "half", "altered"])
def test_broken_update_is_not_correct(broken):
    make = Control if broken == "control" else faulty(broken)
    r = run_cell(CELL, 2 ** 35 + 2, 0.0, False, "cpu", overrides=TINY, make_program=make)
    assert not r["correct"], r["checks"]
    if broken != "control":
        assert r["checks"]["state_gap"]["value"] > r["checks"]["state_gap"]["limit"]


@pytest.mark.cuda
def test_control_at_cell_size(card):
    for seed in (7001, 7002, 7003):
        r = run_cell(CELL, seed, 0.0, False, card, make_program=Control)
        assert not r["correct"], r["checks"]


# --- the readers ------------------------------------------------------------

def _model():
    cfg = spec.load_config("holstein_64_twisted",
                           overrides={"lattice.L": 4, "holstein.beta": 0.6})
    return Model(copy.deepcopy(cfg.run), "cpu", torch.float64)


def _record(device="cuda", trace=True):
    cfg = spec.load_config("holstein_64_twisted")
    steps = [{"complex_update": {"accepted": torch.tensor([True, False, True, True]),
                                 "iters": torch.tensor([10.0, 12.0, 11.0, 11.0])}},
             {"complex_update": {"accepted": torch.tensor([True, True, False, True]),
                                 "iters": torch.tensor([9.0, 9.0, 9.0, 9.0])}}]
    return SimpleNamespace(model=_model(), config=cfg, mix={"trace_steps": 1},
                           device=torch.device(device), steps=steps, window_s=2.0,
                           trace=SimpleNamespace(ops={}) if trace else None,
                           trace_counts={"table_launches": {}, "launch_shapes": set()})


def test_stat_readers():
    rec = _record()
    assert spec.load_reader("acceptance.hmc_complex").read(rec) == 75.0
    assert spec.load_reader("cg_iters_per_solve.hmc_complex").read(rec) == 10.0
    m = rec.model
    Nt = 20
    want = sum(complex_ops.update_flops(it * (Nt + 2), Nt + 1, m.N * m.Lt, m.Nph, m.Lt, 64,
                                        m.bonds.pairs.shape[1], m.N)
               for it in (10.0, 12.0, 11.0, 11.0, 9.0, 9.0, 9.0, 9.0))
    mfu = spec.load_reader("update_mfu.hmc_complex").read
    assert mfu(rec) == pytest.approx(100.0 * want / 2.0 / dev.F32_FLOPS_PER_S, rel=1e-12)
    assert mfu(_record("cpu")) is None


def test_cheb_steps_reader(monkeypatch):
    read = spec.load_reader("cheb_steps_per_update.hmc_complex").read
    monkeypatch.setattr(kpm, "cheb_steps", {"complex": 5632})
    assert read(_record()) == 5632
    assert read(_record(trace=False)) is None
    monkeypatch.delattr(kpm, "cheb_steps")         # a port without the counter
    assert read(_record()) is None


def test_part_counts_each_update_from_zero(monkeypatch):
    """``complex_update.port`` sets the count to 0, so after an update it
    holds that update's steps, whole passes of the cap; a port without
    ``kpm.reset_counts`` still runs."""
    from harness.program import Program

    part = spec.load_module("parts", "complex_update")
    cfg = spec.load_config("holstein_64_twisted", overrides=TINY)
    run = copy.deepcopy(cfg.run)
    traffic = Traffic(2 ** 34 + 3, Model(run, "cpu", torch.float64), cfg.chains, "cpu",
                      torch.float64)
    prog = Program("hmc", run, cfg.chains, "float64", "cpu", 4)
    state = prog.state(traffic.initial_field())
    order = spec.load_reader("update_mfu.hmc_complex").max_order(cfg.run)
    kpm.cheb_steps["complex"] = 10 ** 9
    state, _ = prog.step(part, state, part.draws(traffic, WINDOW, 0))
    n = kpm.cheb_steps["complex"]
    assert 0 < n < 10 ** 9 and n % order == 0
    monkeypatch.delattr(kpm, "reset_counts")
    prog.step(part, state, part.draws(traffic, WINDOW, 1))
    assert kpm.cheb_steps["complex"] > n


def test_mfu_cap_is_the_ports():
    """The cap ``update_mfu.hmc_complex`` counts with is the one the port
    runs on the cell's file: a symmetric apply counts two passes of it."""
    from elphdynamics_tpu_torch.bench import build_hmc_example
    from elphdynamics_tpu_torch.utils.dtypes import field_dtype

    cfg = spec.load_config("holstein_64_twisted", overrides={"lattice.L": 4})
    order = spec.load_reader("update_mfu.hmc_complex").max_order(cfg.run)
    assert order == 64
    ex = build_hmc_example(copy.deepcopy(cfg.run), 2, "cpu", torch.float64, 3)
    st = ex.precond.setup(ex.params, ex.state.x)
    kpm.reset_counts()
    v = torch.randn((2, 1, ex.ops.Nsites, ex.ops.Ltau), dtype=torch.float64)
    ex.precond.symmetric(st, v.to(field_dtype(ex.params, v.dtype)))
    assert kpm.cheb_steps["complex"] == 2 * order


def _marks_record(with_label=True):
    E = spans.Event
    marks = {"cg_block": {"kpm.apply": 0.09}, "step": {"force": 0.01, "kpm.apply": 0.01}}
    if with_label:
        marks["cg_block"]["kpm.cheb_complex"] = 0.08
        marks["step"]["kpm.cheb_complex"] = 0.008
    stat = spans.Stat(count=10, host_s=0.4, self_host_s=0.4, device_s=2.0, self_device_s=2.0)
    one = spans.Stat(count=1, host_s=0.05, self_host_s=0.05, device_s=0.05, self_device_s=0.05)
    return spans.Record(name="hmc.update", index=1, device="cuda",
                        events=[E("hmc.update", None, -1, 0, 30, 2.9)],
                        keys={("graph.replay", "cg_block"): stat, ("graph.replay", "step"): one},
                        replay_s={"cg_block": 0.18, "step": 0.04}, marks=marks)


def test_kpm_cheb_reader(monkeypatch):
    read = spec.load_reader("kpm_cheb_s.hmc_complex").read
    monkeypatch.setattr(spans, "_last", {"hmc.update": _marks_record()})
    assert read(_record()) == pytest.approx(0.08 / 0.18 * 2.0 + 0.008 / 0.04 * 0.05, rel=1e-12)
    assert read(_record(trace=False)) is None
    # a port whose graphs hold other marks but not this one
    monkeypatch.setattr(spans, "_last", {"hmc.update": _marks_record(False)})
    assert read(_record()) is None
    monkeypatch.setattr(spans, "_last", {})
    assert read(_record()) is None
    monkeypatch.delattr(sys.modules["elphdynamics_tpu_torch.utils"], "spans")
    monkeypatch.setitem(sys.modules, "elphdynamics_tpu_torch.utils.spans", None)
    assert read(_record()) is None


def test_k1_complex_roofline(monkeypatch):
    """The complex forms' bound summed per shape over their traced time;
    real launches and other kernels left out; nothing from counts that do
    not add up, from a port without counts per shape, or without a trace."""
    read = spec.load_reader("k1_complex_roofline.hmc_complex").read
    rec = _record()
    m = rec.model
    nb = m.bonds.pairs.shape[1]
    c64 = torch.complex64
    a, b = (32, 1, m.N, 40), (32, m.N, 1)
    counts = {("fold/shared/complex", a, c64): 300, ("fold/shared/complex", b, c64): 40,
              ("fold/shared", (32, m.N, 40), torch.float32): 7}
    rec.trace_counts = {"table_launches": {"fold/shared/complex": 340, "fold/shared": 7,
                                           "fused/shared": 0},
                        "launch_shapes": set(counts)}
    rec.trace = SimpleNamespace(ops={
        "void ckb_fold_kernel<ckb::cplx<float>, 2, false>(ckb::cplx<float> const*)": [0.02, 340],
        "void ckb_fold_kernel<float, 4, false>(float const*)": [9.0, 7],
        "elementwise_kernel": [5.0, 100]})
    monkeypatch.setattr(ckb_cuda, "launch_shapes", counts)
    bound = sum(n * dev.bound_s(complex_ops.k1_bytes(s, "shared", nb, 8),
                                complex_ops.k1_flops(s, nb, m.N))
                for (f, s, _), n in counts.items() if f.endswith("/complex"))
    assert read(rec) == pytest.approx(100.0 * bound / 0.02, rel=1e-12)
    monkeypatch.setattr(ckb_cuda, "launch_shapes", {**counts, ("fold/shared/complex", a, c64): 299})
    assert read(rec) is None
    monkeypatch.setattr(ckb_cuda, "launch_shapes", set(counts))
    assert read(rec) is None
    monkeypatch.setattr(ckb_cuda, "launch_shapes", counts)
    rec.trace = SimpleNamespace(ops={"void ckb_fold_kernel<float, 4, false>(float const*)": [9.0, 7]})
    assert read(rec) is None
    rec.trace = None
    assert read(rec) is None


# --- the counts against brute counts ---------------------------------------

def _real_ops(func, args, out) -> int:
    """Real operations of one elementwise call on complex or real operands."""
    name = func._overloadpacket.__name__
    tensors = [a for a in args if torch.is_tensor(a)]
    cplx = [a.is_complex() for a in tensors]
    if not out.is_complex():
        return {"mul": 1, "add": 1, "sub": 1, "div": 1, "addcmul": 2}.get(name, 0)
    if name in ("add", "sub"):
        return 2
    if name in ("mul", "div"):
        return 6 if len(cplx) == 2 and all(cplx) else 2
    if name == "addcmul":
        return 2 + (6 if all(cplx[1:]) else 2)
    return 0


class Count(TorchDispatchMode):
    """Real operations of the elementwise arithmetic calls."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if torch.is_tensor(out):
            self.n += _real_ops(func, args, out) * out.numel()
        return out


def _twisted(L=4):
    cfg = spec.load_config("holstein_64_twisted",
                           overrides={"lattice.L": L, "holstein.beta": 0.6})
    return TwistedModel(copy.deepcopy(cfg.run), "cpu")


def test_fold_and_mtm_operations():
    m = _twisted()
    C = 3
    x = torch.randn(C, m.Nph, m.Lt, dtype=torch.float64)
    v = torch.randn(C, 1, m.N, m.Lt, dtype=torch.complex128)
    co, der = m.coeffs(m.hopping(x)), m.derived(x)
    nb = m.bonds.pairs.shape[1]
    with Count() as c:
        m.fold(co, v)
    assert c.n == complex_ops.k1_flops(v.shape, nb, m.N)
    with Count() as c:
        m.mulMTM(der, v)
    assert c.n == complex_ops.mtm_flops(v.numel() // C, nb, m.N) * C


def test_cheb_step_operations():
    """One step as the complex recurrence writes it: Ā (a real diagonal and
    the fold), the spectral map, the combine and the coefficient's
    multiply-add into the sum."""
    m = _twisted()
    C = 2
    co = m.coeffs(m.hopping(None))
    u, prev, out = (torch.randn(C, 1, m.N, m.Lt, dtype=torch.complex128) for _ in range(3))
    diag = torch.rand(C, 1, m.N, 1, dtype=torch.float64)
    mag, shift = (torch.rand(C, 1, 1, 1, dtype=torch.float64) for _ in range(2))
    cm = torch.randn(C, 1, 1, m.Lt, dtype=torch.complex128)
    with Count() as c:
        Ap = m.fold(co, diag * u) / mag - shift * u
        nxt = 2.0 * Ap - prev
        out = out + cm * u
    del nxt
    nb = m.bonds.pairs.shape[1]
    assert c.n == complex_ops.cheb_step_flops(u.numel() // C, nb, m.N) * C


def test_k1_bytes():
    shape = (32, 1, 4096, 40)
    nb = 8192
    assert complex_ops.k1_bytes(shape, "shared", nb, 8) == (2 * 32 * 4096 * 40 + 2 * nb) * 8
    assert complex_ops.k1_bytes(shape, "chain", nb, 16) == (2 * 32 * 4096 * 40
                                                            + 2 * 32 * nb) * 16


def test_update_count_is_linear_in_its_parts():
    F, Nph, Lt, M, nb, N = 16 * 10, 16, 10, 64, 32, 16
    one = complex_ops.update_flops(1, 0, F, Nph, Lt, M, nb, N)
    assert one == complex_ops.cg_iteration_flops(F, Lt, M, nb, N)
    assert one == pytest.approx(complex_ops.mtm_flops(F, nb, N)
                                + complex_ops.kpm_flops(F, Lt, M, nb, N) + 24.0 * F)
    assert complex_ops.update_flops(22, 21, F, Nph, Lt, M, nb, N) == pytest.approx(
        22 * one + 21 * complex_ops.force_flops(F, Nph, Lt, nb, N))

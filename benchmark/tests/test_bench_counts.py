"""The frozen counts of ``benchmark/counts`` against brute counts over a
small lattice's operands: bytes from the operands' sizes, operations by
counting every elementwise arithmetic call of a plain computation."""

import copy
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from counts import ops
from harness import spec
from reference.models import Model

ARITH = {"mul": 1, "add": 1, "sub": 1, "div": 1, "addcmul": 2}


class Count(TorchDispatchMode):
    """Elements written by elementwise arithmetic calls."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.n += ARITH.get(func._overloadpacket.__name__, 0) * out.numel()
        return out


def _model(config, L=4):
    cfg = spec.load_config(config, overrides={"lattice.L": L, f"{config.split('_')[0]}.beta": 0.6})
    return Model(copy.deepcopy(cfg.run), "cpu", torch.float64)


@pytest.mark.parametrize("config", ["holstein_64", "ssh_64"])
def test_fold_and_mtm_operations(config):
    m = _model(config)
    C, S = 3, 2
    x = torch.randn(C, m.Nph, m.Lt, dtype=torch.float64)
    v = torch.randn(C, S, m.N, m.Lt, dtype=torch.float64)
    co, der = m.coeffs(m.hopping(x)), m.derived(x)
    nb = m.bonds.pairs.shape[1]
    with Count() as c:
        m.fold(co, v)
    assert c.n == ops.k1_flops(v.shape, nb, m.N)
    with Count() as c:
        m.mulMTM(der, v)
    assert c.n == ops.mtm_flops(v.numel() // C, nb, m.N) * C


def _fused(m, hop, v, pre, a, b, prev):
    u = pre[:, None, :, None] * v
    f = m.fold(m.coeffs(hop), u)
    return a[:, None, None, None] * f + b[:, None, None, None] * v + (-1.0) * prev


def test_k2_operations_and_bytes():
    m = _model("holstein_64")
    C, nb = 2, m.bonds.pairs.shape[1]
    shape = (C, 2, m.N, 2 * ((m.Lt + 1) // 2))
    v, prev = torch.randn(shape), torch.randn(shape)
    pre, a, b = torch.rand(C, m.N), torch.rand(C), torch.rand(C)
    hop = tuple(t.float() for t in m.hopping(None))
    with Count() as c:
        out = _fused(m, hop, v, pre, a, b, prev)
    assert c.n == ops.k2_flops(shape, nb, m.N)
    brute = sum(t.nbytes for t in (v, prev, out, *hop, pre, a, b))
    assert brute == ops.k2_bytes(shape, "shared", nb, 4)


@pytest.mark.parametrize("form", ["shared", "column"])
def test_k1_bytes(form):
    m = _model("ssh_64")
    C, nb = 2, m.bonds.pairs.shape[1]
    v = torch.randn(C, 2, m.N, m.Lt)
    x = torch.randn(C, m.Nph, m.Lt)
    hop = tuple(t.float() for t in m.hopping(x))
    if form == "shared":
        hop = tuple(t[0, :, 0].contiguous() for t in hop)
    out = m.fold(m.coeffs(hop), v)
    brute = sum(t.nbytes for t in (v, out, *hop))
    assert brute == ops.k1_bytes(v.shape, form, nb, 4)


def test_update_count_is_linear_in_its_parts():
    F, Nph, Lt, M, nb, N = 2 * 16 * 10, 16, 10, 8, 32, 16
    one = ops.update_flops(1, 0, F, Nph, Lt, M, nb, N)
    assert one == ops.cg_iteration_flops(F, Lt, M, nb, N)
    assert ops.update_flops(42, 41, F, Nph, Lt, M, nb, N) == pytest.approx(
        42 * one + 41 * ops.force_flops(F, Nph, Lt, nb, N))


def _traced(model, ops_seen, table_launches, launch_shapes):
    from types import SimpleNamespace

    return SimpleNamespace(model=model, trace=SimpleNamespace(ops=ops_seen),
                           trace_counts={"table_launches": table_launches,
                                         "launch_shapes": launch_shapes})


def test_kernel_roofline_from_the_trace():
    """A kernel's share: its counted launches' bound over its traced time;
    nothing where a form's shape is ambiguous or a launch is complex."""
    from harness import device as dev
    from harness.kernels import roofline

    m = _model("ssh_64")
    nb = m.bonds.pairs.shape[1]
    col, chain = (8, 2, m.N, 40), (8, m.N, 1)
    shapes = {("fold/column", col, torch.float32), ("fold/chain", chain, torch.float32),
              ("fused/chain", col, torch.float32)}
    bound = (30 * dev.bound_s(ops.k1_bytes(col, "column", nb, 4), ops.k1_flops(col, nb, m.N))
             + 10 * dev.bound_s(ops.k1_bytes(chain, "chain", nb, 4),
                                ops.k1_flops(chain, nb, m.N)))
    seen = {"void ckb_fold_kernel<float, 4, true>(float const*)": [2e-3, 30],
            "void ckb_fold_kernel<float, 4, false>(float const*)": [1e-3, 10],
            "void ckb_fold_fused_kernel<float, 4>(float const*)": [5e-3, 20],
            "elementwise_kernel": [9.0, 1000]}
    launches = {"fold/column": 30, "fold/chain": 10, "fused/chain": 20, "fold/shared": 0}
    rec = _traced(m, seen, launches, shapes)
    assert roofline(rec, "fold") == pytest.approx(100.0 * bound / 3e-3)
    k2 = 20 * dev.bound_s(ops.k2_bytes(col, "chain", nb, 4), ops.k2_flops(col, nb, m.N))
    assert roofline(rec, "fused") == pytest.approx(100.0 * k2 / 5e-3)
    # a profiler that dropped half the launches: each traced launch at the mean
    half = dict(seen, **{"void ckb_fold_fused_kernel<float, 4>(float const*)": [2.5e-3, 10]})
    assert roofline(_traced(m, half, launches, shapes), "fused") == pytest.approx(
        100.0 * k2 / 5e-3)
    # one form through two shapes, a complex launch, no trace: nothing to read
    two = shapes | {("fold/chain", (4, m.N, 1), torch.float32)}
    assert roofline(_traced(m, seen, launches, two), "fold") is None
    cplx = dict(launches, **{"fold/chain/complex": 3})
    assert roofline(_traced(m, seen, cplx, shapes), "fold") is None
    assert roofline(_traced(m, {}, launches, shapes), "fold") is None

"""The site-sharded Holstein HMC update of the PyTorch port on a twisted
lattice (complex hopping: complex halos, conj(s) on the second endpoint of
a bond) and with a dynamic dt (the burn-in tuner's step), against the JAX
package's unsharded ``make_hmc_step`` and the port's one-rank step on 2 and
4 gloo ranks; the checks of ``test_torch_parallel_hmc.py``.

Block CG on complex fields (Hermitian block CG, its complex128 Grams
all-reduced over the site group) on 2 site ranks and on the 2 chain × 2
site layout, against the port's one-rank run, float64, twisted 4×4, 4
chains: one HMC update whose trajectory solves run block CG (s = 1) and
the nᵥ = 4 probe solves of a Green's-function sample by block CG (tol
1e-10). x and the probe solutions to 1e-12, equal decisions, iterations
and flags on every rank, and block CG called on every rank.
"""

import numpy as np
import pytest

import torch_parallel_workers as W
from elphdynamics_tpu_torch.parallel.multihost import launch
from test_torch_parallel_hmc import _check


@pytest.mark.parametrize("D", [2, 4])
@pytest.mark.parametrize("case,dt", [("twist", None), ("plain", 0.04)],
                         ids=["twist", "dynamic_dt"])
def test_sharded_hmc_update_matches_jax(case, dt, D, tmp_path):
    _check(case, dt, D, tmp_path)


def check_twisted_block(model: str, n_chain: int, n_site: int, tmp_path):
    """:func:`W.twisted_block_worker` on ``n_chain`` × ``n_site`` gloo ranks
    against the one-rank run of rank 0."""
    ranks = launch(W.twisted_block_worker, n_chain * n_site, "gloo", "cpu",
                   (model, n_chain, n_site), timeout_s=240, threads=1, store_dir=str(tmp_path))
    one = ranks[0]["one"]
    holstein = model == "holstein"
    for field, site_axis in (("x", holstein), ("MinvR", True)):
        whole = W.layout_whole(ranks, "sharded", field, n_chain, n_site, site_axis)
        np.testing.assert_allclose(whole, one[field], rtol=0, atol=1e-12, err_msg=field)
    for k in ("accepted", "iters", "flag", "giters", "gflag"):
        got = W.layout_whole(ranks, "sharded", k, n_chain, n_site, False)
        np.testing.assert_array_equal(got, one[k], err_msg=k)
        for r, rank in enumerate(ranks):  # every rank of a site group agrees
            first = ranks[(r // n_site) * n_site]["sharded"][k]
            np.testing.assert_array_equal(rank["sharded"][k], first, err_msg=k)
    if not holstein:  # the bond field is whole and bit for bit the same on every site rank
        for r, rank in enumerate(ranks):
            np.testing.assert_array_equal(rank["sharded"]["x"],
                                          ranks[(r // n_site) * n_site]["sharded"]["x"])
    assert int(one["flag"].max()) == int(one["gflag"].max()) == 0
    assert one["block_calls"] > 0 and all(r["sharded"]["block_calls"] > 0 for r in ranks)


@pytest.mark.parametrize("n_chain,n_site", [(1, 2), (2, 2)], ids=["site2", "layout2x2"])
def test_twisted_block_cg_on_ranks_equals_one_rank(n_chain, n_site, tmp_path):
    check_twisted_block("holstein", n_chain, n_site, tmp_path)

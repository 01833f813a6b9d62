"""Drive the PyTorch port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (one line each, and the process exits non-zero if any fails):

1. the card (``nvidia-smi`` name and power limit), torch/CUDA versions and
   the TF32 switches;
2. build the two CUDA kernels, the checkerboard fold (K1, ``csrc/
   ckb_fold.cu``) and the fused Chebyshev step (K2, ``csrc/
   ckb_fold_fused.cu``), one nvcc per source, started together;
3. K1 against its plain torch twin in all four directions at the main
   path's shapes, float32 and float64, with device times per launch;
4. K2 against its plain twin at [16, 1, 4096, 40] and [16, 10, 4096, 40]
   (16 chains, nᵥ = 10 rows each) with per-chain scalars and diagonals,
   with and without ``prev``, both directions, float32 and float64; for
   both kernels at their main shape (f32, K1 [32, 4096, 40] forward, K2
   [16, 10, 4096, 40] with prev) also the bound (bytes over the card's
   memory rate) and ``torch.matmul`` by the assembled dense [N, N]
   checkerboard matrix (TF32 off), the one-call library form of the fold;
5. the kernels' coefficient-table modes of the SSH model at the shapes
   its 64×64 update launches, against the twins, float32 and float64, all
   directions: K1 with per-(chain, bond, τ) tables [8, 4096·2, 40] on
   [8, 2, 4096, 40] (the fermion operator), K1 with per-chain tables on
   [8, 4096, 1] (the power iteration) and [8, 2, 4096, 40] (Ā on a CG
   block), K2 with per-chain tables on [8, 2, 4096, 40] with and without
   ``prev``; each with device ms, plain ms, bound and the one-call library
   form (for the per-column tables one batched ``torch.matmul`` by the
   [8, 40, 4096, 4096] stack of dense matrices, one per chain and column,
   21.5 GB, assembled from the twin's fold of the identity; in phase 15
   complex64, 43 GB);
6. a small update (4×4, float64) on the card with K1 forced on, against
   the same update on the CPU through the plain twin; the same for a 4×4
   SSH update with the dense Ā switched off, so that K1 runs in both its
   SSH modes and K2 with per-chain tables;
7. a small preconditioner apply (4×4, float64) on the fold branch: K2 on
   the card against its twin on the CPU;
8. the bench 8×8 configuration (128 chains, dense branch): 1 warm-up and 2
   timed updates, through the graphed update (``dynamics/graphs.py``; the
   warm-up update captures; its graph replays counted, > 0);
9. the kernel 64×64 configuration (16 chains, fold branch, N = 4096): 1
   warm-up and 2 timed updates through the graphed update, with K1's and
   K2's launch counts (launches inside the graphs count once per replay); and the
   SSH 64×64 configuration (8 chains): 1 warm-up and 2 timed updates
   through the graphed update, with the launch counts of each kernel mode;
10. the 64×64 A/B of the two fold-branch Chebyshev recurrences (K2 steps
    against K1 plus elementwise passes) on one KPM state;
11. the TOML driver, ``simulation.simulate``: ``examples/
    holstein_hmc_square.toml`` and ``examples/ssh_hmc_square.toml``, each
    with its counts cut (4×4, dense branch) and at 64×64, β = 4 (4 chains,
    K1 and K2 on the path), each into a temporary directory, with seconds
    per update and per measurement and the peak device memory; every run
    replays the graphs of the update, of the moves its file configures and
    of the measurement (Holstein and SSH; replays > 0 for each part);
12. Langevin dynamics and the other solver kinds, 4×4 float64 on the card
    (K1 forced on, the dense Ā off) against the CPU: one Euler, one
    Runge-Kutta and one Heun step with the same injected draws, Holstein
    and SSH (the graphed step, replays > 0); ``solve_minv`` and ``solve_oinv`` by GMRES and by BiCGStab with
    the left and right KPM applies; a block-CG probe solve; 1e-10 in x;
13. the Langevin configurations at full width, ``LANGEVIN_64X64`` (16
    chains) and ``SSH_LANGEVIN_64X64`` (8 chains): 1 warm-up and 3 timed
    Runge-Kutta steps through the graphed step (replays > 0), steps per
    second, CG iterations per solve, flags 0, launch counts per kernel
    mode; and on the kernel 64×64 model nᵥ = 10
    probe solves per chain by CG and block CG: iterations, seconds, the
    solutions' distance, K2 launches (GMRES and BiCGStab, with the left
    apply, held to CG's solution: phase 43; block CG on complex fields at
    full width: phase 42);
14. the TOML driver on ``examples/holstein_langevin_square.toml`` with its
    counts cut, and the same file at 64×64, β = 4 (4 chains, a few steps,
    one measurement) with BondBond, CurrentCurrent and BondPairGreens
    switched on (nᵥ = 10; BondBond and BondPairGreens time dependent);
    both runs step through the graphed Langevin step (replays > 0);
15. K1's complex mode (complex hopping: twisted boundaries) against its
    twin in complex64 and complex128, all directions, in its three table
    forms at the twisted 64×64 shapes: [Nb] tables on [16, 4096, 40] and
    [16, 4096, 1], per-(chain, bond, column) tables on [8, 1, 4096, 40],
    per-chain tables on [8, 1, 4096, 40], [8, 4096, 1] and [8, 4096, 4096]
    (a densified Ā); device ms (forward), plain ms, bound and the dense
    complex matmul (per-column tables: the batched matmul by the
    [8, 40, 4096, 4096] complex64 stack, 43 GB);
16. twisted 4×4 float64 runs on the card (K1 forced on, the dense Ā off,
    so the complex KPM recurrence runs K1) against the CPU with the same
    draws: a Holstein and an SSH HMC update, a Holstein Runge-Kutta
    Langevin step and a Holstein measurement with every on-site
    correlation and CurrentCurrent; block CG on complex fields (Hermitian
    block CG): nᵥ = 4 probe solves of M (tol 1e-10) and a Holstein and an
    SSH HMC update with ``[solver] block`` (trajectory solves at s = 1), x
    within 1e-12, equal iterations and decisions;
17. (folded into phase 40, which runs ``TWISTED_64X64`` and
    ``SSH_TWISTED_64X64`` graphed and eager and checks every complex K1
    form on their paths launched, flags 0 and acceptance > 0);
18. the TOML driver on ``examples/holstein_hmc_twisted.toml`` and
    ``examples/ssh_hmc_twisted.toml``, one update and one measurement each,
    both replaying their graphs (replays > 0 for each part);
19. the deep-β samplers and solver aids, 4×4 float64 on the card (K1 forced
    on, the dense Ā off) against the CPU with the same draws: a 2MN update,
    a dynamic-dt update, a tempering exchange (Holstein and SSH, λ or α per
    chain), a deflated and a near-null solve; x within 1e-12, equal
    iterations and decisions;
20. (went to phase 41, which runs ``KERNEL_2MN_64X64`` and
    ``TEMPERING_64X64`` graphed against eager, with their flags, acceptance
    and the exchange acceptance);
21. both kernels at the deep-β shapes (K = 160: K1 [8, N, 160] and the
    deflation filter's [128, N, 160], K2 [4, 2, N, 160] and [4, 32, N, 160]
    with prev), against the twin, with device ms, plain ms, bound and the
    dense matmul (the ``DEEP_BETA_64X64`` solves: phase 42, graphed and
    eager);
22. the TOML driver on ``examples/holstein_hmc_deep_beta.toml`` (as shipped,
    cut in depth to 4 tuned + 1 sampling update; the tuned dt) and on the
    stock 4×4 Holstein example with a ``[tempering]`` ladder on 8 chains
    (the exchange rate);
23. every (kernel, coefficient form, field shape) that one of the 64×64
    runs of phases 9, 11, 13, 14, 24, 29 and 36–42 launched
    (``ckb_cuda.launch_shapes``),
    against the twin in float32 and float64 (complex64 and complex128 for
    K1's complex mode), all directions, at every launch geometry the
    wrapper's tuning may keep for that shape, so that no run goes through a
    row count or geometry that was not checked.
24. (a) chain sharding: 2 gloo ranks sharing card 0 run ``KERNEL_64X64``
    (16 chains, 8 per rank; 1 warm-up and 2 timed updates), each launching
    K1 and K2 (counts set to 0 just before, read just after, summed over
    the ranks): every chain's x bit for bit against the same two blocks
    run one after the other in this process, and against the one-rank
    16-chain run of phase 9 (equal decisions; x differs at float32
    rounding, torch's sums over 8 chains adding in another order); the
    driver on the stock 4×4 Holstein example (4 chains, float64, cut in
    depth) on 2 chain ranks against one rank: x and bins to 1e-9;
25. (b) site sharding at 4×4, float64, 2 gloo ranks, against the unsharded
    card run: an HMC update with KPM and warm starts, a twisted update, a
    twisted update with ``[solver] block`` and the block-CG probe solves
    of a twisted Green's-function sample (tol 1e-10), reflection and swap
    moves, a Runge-Kutta Langevin step and a Green's-function sample; x to
    1e-12 (the plain sample's probe solutions 1e-10), equal decisions and
    iterations (run in the 2-rank launch of (e)–(g));
26. (c) replaced by (g)'s ``KERNEL_64X64`` on the 2×2 layout, which
    covers it;
27. (e) SSH site-sharded at 4×4, float64, on 2 gloo ranks against the
    unsharded card run: an HMC update with KPM and warm starts, a twisted
    update, a twisted block-CG update and block-CG probe solves, swap (and
    the null reflection) moves, a Runge-Kutta Langevin step, a
    Green's-function sample; x to 1e-12 (the plain sample's probe
    solutions 1e-10),
    equal decisions and iterations, and the bond field bitwise equal on
    both ranks after each sampler;
28. (f) 4×4 float64 on 4 ranks (2 chain × 2 site) against one rank: an HMC
    update with slow-mode deflation and block-CG probe solves (1e-9), a
    twisted HMC update with ``[solver] block`` and block-CG probe solves
    on complex fields (1e-12), tempering exchanges of both parities
    (Holstein and SSH); and the stock 4×4 SSH
    example through the driver on 2 site ranks (cut in depth to 1 + 2
    updates, KPM order 8): x and bins to 1e-9, equal decisions. At
    0 + 2 updates the bins differ by 7.2e-9 on ``Nsqr`` (|Nsqr| = 257.5):
    every solve agrees to ≤ 1.5e-15 in ‖x‖² up to the second
    measurement's probe solve (CG on MᵀM, tol 1e-5, 11/11/12/11
    iterations on both layouts, residuals 9.71e-6, 9.64e-6, 2.68e-6,
    9.80e-6, equal to 1.5e-9), whose solutions differ by 2.6e-11 in ‖x‖²:
    the one-rank run folds with K1 and the ranks with the plain halo fold,
    whose roundings that solve amplifies by its conditioning, not by a
    stopping threshold. On the CPU a ±1 half-ulp perturbation of every
    fold gives 7.0e-9 on ``Nsqr`` at seed 26 and ≤ 1.1e-13 at seeds
    17–25 (``scripts/ssh_site_parity.py``); 1 + 2 updates agree to
    3.2e-14;
29. (g) at full width, trajectories cut to 0.1: one site-sharded
    ``SSH_64X64`` update (8 chains, D = 2) and ``KERNEL_64X64`` on the 2×2
    layout (8 chains per block), each after a warm-up update, with seconds
    beside the same update of one site group's chains on one rank, CG
    iterations, flags, halo messages and bytes per fold, all-reduces, and
    SSH's force all-reduce bytes per force evaluation ([8, 8192, 40]
    float32); the ranks of each site group must agree on the decisions,
    the iterations and (SSH) the bits of the whole bond field; then
    each chain block's measurement on its gathered lattice (Greens, 2
    probes; K1 and K2); a 64×64 SSH ladder (4 rungs × 2 lanes) on 2 chain
    ranks against one rank (``TEMPERING_64X64`` on 2 chain ranks against
    one rank: phase 41); K1 and K2 launches per rank in
    ``launches_by_path``;
30. (d) (a), (b), (e)–(g) and phase 41's chain ranks with one NCCL rank per
    card when the machine has two cards (the 2×2 layout with four), else
    one line saying why not; there a site shard's calls replay CUDA graphs
    with the site group's all-reduces and halo exchanges inside them, and
    the graphed site shards are held to their eager forms on the same
    draws, bit for bit: the 4×4 float64 samplers of
    ``tests/torch_parallel_workers.graph_sites_worker`` (updates, the dt
    tuner's, block CG, deflation, Langevin, moves, probe solves; Holstein
    with and without ωᵢⱼ, SSH, twisted) on 2 site ranks and a laddered
    update and exchange on 2×2, then ``KERNEL_64X64`` and ``SSH_64X64`` at
    D = 2 (the dt tuner's update too) and ``KERNEL_64X64`` on 2×2, with
    sweeps/s graphed against eager and against one rank's graphed update of
    the same chains, busy shares, replays = host reads + 1, the site
    groups agreeing on decisions, iterations, host reads, replays and SSH's
    bond field (``chiprun_out/graphed_sites_nccl.json``);
31. (folded into phase 42, which runs the same block-against-CG checks on
    the graphed measurement's probe solves);

32. ``[solver] loop_precision``: one in-loop exp(−Δτ·K) apply and one of
    its adjoint at "high" (three bf16 products accumulated in float32), at
    "default" (one) and at "highest" against float64 at the bench 8×8 and
    32×32 dense shapes; "high" and "default" must differ from float32, stay
    within ``BF16X3_GATE`` and ``BF16X1_GATE`` of max|A|·|y|, and "default"
    must be the less accurate;
33. independent draws across seeds with the CUDA generator: the driver on
    ``examples/holstein_hmc_square.toml`` at 64×64 (4 chains) at seeds 2,
    3 and 4, stopped once its first update has drawn; every chain's x₀,
    momenta, pseudofermions and Metropolis uniform differ between seeds
    (and between chains); the uniforms are printed;
34. the float32 single-site anchor of ``tests/test_accum.py`` on the card:
    ``ED_CHAINS`` chains, ``ED_BURNIN`` + ``ED_MEAS`` updates, density and
    ⟨x²⟩ against exact diagonalisation within 0.08 and 0.1, the two
    measured halves' ⟨x²⟩ within ``ED_FLAT_SIGMAS`` standard errors;
35. the HMC energy in float32 against float64 on the same draws (the 64×64
    driver run's model, 4 chains, one leapfrog step): H at the start within
    u·(|S| + K) per chain, ΔH within twice that.

36. the graphed update (``dynamics/graphs.py``: the one-rank Holstein
    leapfrog CG update captured as CUDA graphs, replayed) against the eager
    update, asked for by name, at bench 8×8, 32×32 (dense matmuls that
    cuBLAS plans under capture at N = 1024) and ``KERNEL_64X64`` (K1
    and K2 inside the graphs): two updates each way on
    the same draws from the same state, bit for bit or x within
    ``GRAPH_X_REL_TOL`` and ΔH within 2u·(|S| + K), equal decisions, flags
    and iterations, replays = host reads + 1, and on the second update
    equal K1 / K2 launches by form
    and equal host reads; the graphs, capture seconds, pool bytes and
    replays per update; the graphed update's busy share (its replays' CUDA
    event spans over wall time; ``chiprun_out/graphed_update.json``). The
    interleaved sweeps/s blocks of phases 36 and 37 went to pay for phase
    40.
37. the same for the graphed SSH update at ``SSH_8X8`` (64 chains, the
    dense-Ā branch: K1 per-column, and K1 per-chain re-densifying Ā on
    every KPM refresh) and ``SSH_64X64`` (8 chains, the fold branch: K1
    per-column, K1 per-chain at K = 1, K2 per-chain), each kernel form
    launched inside the graphs as often as in the eager update (JSON
    ``graphed_update_ssh.json`` beside phase 36's).
38. the graphed Langevin step (``dynamics/langevin.py``: the one-rank CG
    step's segments as CUDA graphs) against the eager step, asked for by
    name, at ``LANGEVIN_64X64`` (16 chains, RK; K1 and K2 inside the
    graphs), ``SSH_LANGEVIN_64X64`` (8 chains, RK; K1 per-chain and
    per-column, K2 per-chain) and the stock
    ``examples/holstein_langevin_square.toml`` step (4×4, one chain): two
    steps each way on the same draws from the same fields, x bit for bit or
    within ``GRAPH_X_REL_TOL``, equal iterations and flags, replays = host
    reads + 1, equal K1 / K2 launches by form on the second step; graphs,
    capture seconds, pool bytes and busy share (``chiprun_out/
    graphed_langevin.json``); at 4×4, ``LANGEVIN_LONG_STEPS`` graphed steps
    with no growth of allocated device memory between step 5 and the last,
    and none over ``LANGEVIN_REBUILDS`` steps built afresh; then the
    allocated memory against what Python reaches, by memory pool.
39. the graphed reflection, swap and measurement (``dynamics/
    special_updates.py``, ``measure/measurements.py``: each part's segments
    as CUDA graphs) against the eager ones, asked for by name, on the
    driver steps of ``examples/holstein_hmc_square.toml`` and
    ``ssh_hmc_square.toml`` (4×4, one chain) and of both files at 64×64,
    β = 4, 4 chains, nᵥ = 10 (K1 and K2 inside the graphs;
    ``bench.build_hmc_example``): two calls of each part each way on the
    same draws from the same fields, x, acceptance and every increment bit
    for bit, equal iterations and flags, replays = host reads + 1, equal K1
    / K2 launches by form on the second call; graphs, capture seconds and
    pool bytes (``chiprun_out/graphed_special_measure.json``); at stock
    Holstein 4×4, ``SPECIAL_MEMORY_CALLS`` graphed measurements with no
    growth of allocated device memory; the 64×64 Holstein measurement at
    ``BLOCKED_CHAINS`` chains, its estimators in blocks of chains
    (``measurements.analyze_chains``), graphed, eager and graphed in one
    block of every chain on the same probes: bit for bit, replays = host
    reads + 1, and the blocks' peak of allocated memory below the one
    block's. Phase 11's driver runs replay the graphs of the update, the
    moves and the measurement. (The interleaved blocks of phases 38 and 39
    went to pay for phase 40.)
40. complex hopping graphed: the same checks against the eager calls at
    ``TWISTED_64X64`` (16 chains) and ``SSH_TWISTED_64X64`` (8 chains) for
    the HMC update, ``TWISTED_LANGEVIN_64X64`` (16 chains) for the RK
    Langevin step, and on the moves and measurement of
    ``examples/holstein_hmc_twisted.toml`` and ``ssh_hmc_twisted.toml`` (the
    square files' moves added: the twisted files configure none) at 4×4
    (one chain) and 64×64 (4 chains): every result bit for bit on the same
    draws, replays = host reads + 1, equal K1 complex launches by form
    (``fold/shared/complex``, ``fold/column/complex``,
    ``fold/chain/complex``), busy shares, capture seconds and pool bytes
    (its interleaved A/B blocks went to pay for phase 41), and
    ``TWISTED_MEMORY_STEPS`` graphed twisted SSH 4×4
    driver steps with no growth of allocated memory (``chiprun_out/
    graphed_complex.json``). Its 64×64 runs' shapes enter phase 23 and
    ``launches_by_path``.
41. the chain-batched calls graphed (chain ranks, tempering, 2MN), each
    against its eager form: ``KERNEL_2MN_64X64`` (16 chains) and
    ``TEMPERING_64X64``'s laddered update and exchange (both parities) on
    one rank, with interleaved A/B blocks (sweeps/s; a tempering block is 2
    updates and an exchange) and the exchange's seconds; on 2 gloo ranks
    sharing card 0 ``KERNEL_64X64`` (8 chains a rank; its A/B), the 64×64
    reflection and swap (4 chains a rank) and ``TEMPERING_64X64``'s update
    and exchange across the ranks, the ranks' decisions and exchange rates
    held to the one-rank runs of the same sequence (phase 36's
    ``KERNEL_64X64``; the one-rank ``TEMPERING_64X64`` here): every result
    bit for bit on the same draws, equal K1 / K2 launches by form,
    replays = host reads + 1 per run of segments between the exchange's two
    gathers, flags 0 and acceptance > 0 (phase 20's checks); a dispersive 64×64
    update run twice on the same draws (bit for bit) beside the old
    ``index_add`` force rerun on one field; and ``TEMPERING_MEMORY_STEPS``
    graphed tempering driver steps of the stock 4×4 Holstein file on 8
    chains with no growth of
    allocated memory (``chiprun_out/graphed_chains.json``). Its runs' shapes
    enter phase 23 and ``launches_by_path``; ``nccl_only()`` runs its ranks'
    part on NCCL ranks, one card each.
42. the CG solver aids graphed: first both kernels at the new shapes the
    aids give them at 64×64 (K1 [512 | 256 | 40, 4096, 40], K2
    [16, 32 | 16, 4096, 40] and [4, 10, 4096, 40] with prev) against the
    twin with device ms, plain ms, bound and the dense matmul; then each
    aid against its eager form on the same
    draws (bit for bit or x within ``GRAPH_X_REL_TOL``, equal decisions,
    iterations and flags, replays = host reads + 1, equal K1 / K2 launches
    by form): the updates of ``BLOCK_64X64`` (block CG over the spins),
    ``DEFLATED_64X64`` (k = 32; the refreshed basis compared too),
    ``NEARNULL_64X64`` (k 16, c 4) and ``LOWFREQ_32X32`` (the dense Ā's
    exact low-frequency blocks), each with its busy share and interleaved
    sweeps/s blocks, flags 0 and acceptance > 0; the 64×64 Holstein
    measurement (4 chains, nᵥ = 10) with block probes and its seconds per
    call each way; phase 31's block-against-CG checks on the graphed
    measurement's complex probe solves at ``TWISTED_64X64`` and
    ``SSH_TWISTED_64X64`` (flags, ‖M·X − R‖/‖R‖ ≤ √tol,
    ``BLOCK_VS_CG_GATE``, every complex K1 form launched, bit for bit
    against the eager call); the three ``DEEP_BETA_64X64`` solve kinds
    graphed and eager (set-up and solve seconds, busy share, pool, peak
    memory); ``AIDS_MEMORY_UPDATES`` graphed deflated 4×4 updates with no
    memory growth (``chiprun_out/graphed_aids.json``). Its 64×64 runs'
    shapes enter phase 23 and ``launches_by_path``.
43. BiCGStab and GMRES graphed (``dynamics/graphs.NonsymSolve``), each
    against its eager form on the same draws: bit for bit, replays = host
    reads + 1 (an eager retry's reads apart), equal K1 / K2 launches by
    form, flags as in the eager form: the ``GMRES_64X64`` and
    ``BICGSTAB_64X64`` updates (their trajectories cut to 10 steps,
    ``NONSYM_TRAJECTORY``) and the ``GMRES_LANGEVIN_64X64`` step (16
    chains each; busy share, interleaved sweeps/s or chain-steps/s blocks,
    pool bytes, capture seconds), the 64×64 Holstein measurement (4 chains,
    nᵥ = 10) with GMRES probes and its seconds per call each way, and phase
    13's GMRES and BiCGStab probe solves held to its CG solution
    (``chiprun_out/graphed_nonsym.json``). Its runs' shapes enter phase 23
    and ``launches_by_path``.

44. a site shard graphed on one card: a one-rank NCCL site group
    (``multihost.launch(fn, 1, "nccl")``) runs a D = 1 site shard of
    ``KERNEL_64X64`` and of ``SSH_64X64`` (every site in the block: no
    halo, every all-reduce an NCCL op inside the graphs), trajectories cut
    to ``SHORT_TRAJECTORY``, two updates each graphed against the eager
    form on the same draws: bit for bit, equal shard counters in the
    second (a graph's counted at its capture and added at each replay; the
    first also counts the warm-up), replays = host reads
    + 1, the all-reduces each graph holds per replay
    (``chiprun_out/graphed_sites.json``).

Phases 36–42 run after 9, 43 and 44 after 13, 32 after 19, 33, 35 and 34
after 22; phases 24–30 run before 23, which comes last.

The line before the last is a JSON object with the kernels' numbers, one
entry per kernel and coefficient mode (``launches`` summed over the 64×64
driver runs and Langevin configurations that use the mode,
``launches_by_path`` each run's own); the last line is ``{"ok": true,
"device": {...}}``. Kernel times (``ms``,
``plain_ms``, ``library_ms``) are device time per call: calls captured in a
CUDA graph and replayed between CUDA events, so a host slower than the card
does not enter them; ``call_ms`` in the phase lines is one call after a
synchronisation (CUDA events, median of 20), host time before the launch
included. The first launch of each kernel at a new shape times its launch
geometries and keeps the fastest (``ops/ckb_cuda.candidates``); the
kernel-vs-twin phases make that launch before they time.
"""

from __future__ import annotations

import contextlib
import gc
import hashlib
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
import tomllib
from dataclasses import replace

import numpy as np
import torch

F32_TOL = 1e-5
F64_TOL = 1e-12
HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory
F32_FLOPS_PER_S = 67e12       # H100 SXM float32 outside the tensor cores
F64_FLOPS_PER_S = 34e12       # H100 SXM float64 outside the tensor cores
# the tolerance of each field dtype (complex: its real type's)
TOLS = {torch.float32: F32_TOL, torch.float64: F64_TOL, torch.complex64: F32_TOL,
        torch.complex128: F64_TOL}
DIRECTIONS = (("forward", False, 1.0), ("transpose", True, 1.0),
              ("inverse", True, -1.0), ("inverse_transpose", False, -1.0))


T_START = time.perf_counter()


def say(phase: str, **kv) -> None:
    """One line of a phase; ``at``: seconds since the script started."""
    kv["at"] = f"{time.perf_counter() - T_START:.1f}"
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()), flush=True)


def device_ms(fn, reps: int = 30, replays: int = 3) -> float:
    """Device time per call: ``reps`` calls captured in one CUDA graph
    (after a warm-up call on the capture stream), the graph replayed
    ``replays`` times between two CUDA events, over ``replays``·``reps``.
    The captured launches run back to back on the card, so the host's pace
    does not enter, and no profiler trace (CUPTI) is needed. The capture
    stream is the port's (``graphs.capture_stream``): a fresh stream per
    call would leave a cuBLAS workspace on each."""
    from elphdynamics_tpu_torch.dynamics.graphs import capture_stream

    stream = capture_stream(torch.device("cuda"))
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()
    stream.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream, capture_error_mode="relaxed"):
        for _ in range(reps):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / (replays * reps)
    graph.reset()
    return ms


def bound(nbytes: float, flops: float, flops_per_s: float = F32_FLOPS_PER_S
          ) -> tuple[float, str]:
    """The least time (ms) for ``nbytes`` of device memory traffic and
    ``flops`` operations at ``flops_per_s`` (float32 by default), and which
    of the two sets it."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / flops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def library_ms(spec, c, s, v) -> float:
    """``torch.matmul`` by the assembled dense [N, N] checkerboard matrix
    (one per chain for per-chain [C, Nb] tables) on ``v`` [C, ..., N, K]
    (float32 or complex64, TF32 off): the one PyTorch call that computes the
    fold. Timed here only; the port never calls it."""
    from elphdynamics_tpu_torch.ops import checkerboard as ckb

    c, s = (t.to(torch.complex128 if t.is_complex() else torch.float64).cpu().numpy()
            for t in (c, s))
    if c.ndim == 1:
        dense = torch.as_tensor(ckb.dense_matrix(spec, c, s), dtype=v.dtype, device=v.device)
    else:
        dense = torch.stack([torch.as_tensor(ckb.dense_matrix(spec, ci, si), dtype=v.dtype,
                                             device=v.device) for ci, si in zip(c, s)])
        dense = dense.reshape(dense.shape[:1] + (1,) * (v.ndim - 3) + dense.shape[1:])
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return device_ms(lambda: torch.matmul(dense, v), reps=5)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def library_ms_columns(spec, c, s, v) -> float:
    """One batched ``torch.matmul`` by the ``[C, K, N, N]`` stack of dense
    checkerboard matrices, one per chain and column of the per-(chain,
    bond, column) tables ``c``, ``s`` ``[C, Nb, K]``, on the field ``v``
    ``[C, S, N, K]`` laid out as ``[C, K, N, S]`` (the permute not timed),
    TF32 off: the one PyTorch call that computes the per-column fold. Each
    matrix is the plain fold of the identity, assembled on the card (21.5
    GB in float32 and 43 GB in complex64 at SSH 64×64's ``[8, 8192, 40]``
    tables). Timed here only; the port never calls it."""
    from elphdynamics_tpu_torch.ops import checkerboard as ckb

    C, K, N = c.shape[0], c.shape[-1], v.shape[-2]
    eye = torch.eye(N, dtype=v.dtype, device=v.device)
    dense = torch.empty((C, K, N, N), dtype=v.dtype, device=v.device)
    for ci in range(C):
        for k in range(K):
            dense[ci, k] = ckb.fold(spec, c[ci, :, k].contiguous(), s[ci, :, k].contiguous(), eye)
    del eye
    vp = v.permute(0, 3, 2, 1).contiguous()
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return device_ms(lambda: torch.matmul(dense, vp), reps=3, replays=2)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
        del dense, vp
        torch.cuda.empty_cache()


def _outputs(fn, spec, c, s, v, kw: dict, acc0=None) -> tuple:
    """``fn`` (a kernel or its twin) on one input: its output and, for K2
    (``acc0``: the start sum), the sum it added into a copy of ``acc0``."""
    if acc0 is None:
        return (fn(spec, c, s, v, **kw),)
    acc = acc0.clone()
    return fn(spec, c, s, v, acc=acc, **kw), acc


def _errors(got: tuple, want: tuple) -> tuple[float, float]:
    """The largest error of the outputs ``got`` against ``want``: relative
    (each output to its own max|want|) and absolute."""
    pairs = list(zip(got, want))
    return (max(((x - y).abs().max() / y.abs().max()).item() for x, y in pairs),
            max((x - y).abs().max().item() for x, y in pairs))


def _k2_operands(v, g, init: bool = False) -> tuple:
    """A start sum and per-chain ``[C, K]`` coefficients for K2 on ``v``:
    the start sum, and the keywords ``coeff`` and ``init``."""
    coeff = torch.randn((v.shape[0], v.shape[-1]), generator=g, dtype=v.dtype, device=v.device)
    return torch.randn(v.shape, generator=g, dtype=v.dtype, device=v.device), \
        dict(coeff=coeff, init=init)


def median_ms(fn, reps: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def phase_card() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    say("card", torch=torch.__version__, cuda=torch.version.cuda,
        device=repr(torch.cuda.get_device_name(0)), count=torch.cuda.device_count(),
        matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
        cudnn_allow_tf32=torch.backends.cudnn.allow_tf32)
    return smi


def phase_build():
    from elphdynamics_tpu_torch.ops import ckb_cuda

    t0 = time.perf_counter()
    libs = ckb_cuda.build(verbose=True)
    say("build", libraries=",".join(so.name for so in libs.values()),
        seconds=f"{time.perf_counter() - t0:.2f}")


def _spec_64():
    from elphdynamics_tpu_torch.bench import KERNEL_64X64
    from elphdynamics_tpu_torch.lattice import Lattice, UnitCell
    from elphdynamics_tpu_torch.models.holstein import build_holstein

    uc = UnitCell.create(2, 1, [[1.0, 0.0], [0.0, 1.0]], [[0.0, 0.0]])
    lat = Lattice.create(uc, KERNEL_64X64.L)
    spec, params = build_holstein(
        lat, beta=KERNEL_64X64.beta, dtau=KERNEL_64X64.dtau,
        t_assignments=[(1.0, 0.1, 0, 0, (1, 0, 0)), (1.0, 0.1, 0, 0, (0, 1, 0))],
        rng=np.random.default_rng(0), device="cuda")
    return spec, params


def phase_kernel_vs_twin() -> dict:
    """The kernel and the plain twin on the same inputs: the fermion operator
    shape [2·16 chains, 4096, Lτ=40] (the KPM's [32, 4096, 2Lω=40] too), the
    power-iteration shapes [16, 4096, 1] and [1, 4096, 1]."""
    from elphdynamics_tpu_torch.ops import checkerboard as ckb
    from elphdynamics_tpu_torch.ops import ckb_cuda

    spec, params = _spec_64()
    g = torch.Generator(device="cuda").manual_seed(0)
    worst_abs = 0.0
    main = {}
    for dtype, tol in ((torch.float32, F32_TOL), (torch.float64, F64_TOL)):
        c, s = params.cosht.to(dtype), params.sinht.to(dtype)
        for shape in ((32, spec.Nsites, 40), (16, spec.Nsites, 1), (1, spec.Nsites, 1)):
            v = torch.randn(shape, generator=g, dtype=dtype, device="cuda")
            for name, rev, sign in DIRECTIONS:
                got = ckb_cuda.fold(spec.ckb, c, s, v, reverse=rev, sign=sign)
                want = ckb.fold(spec.ckb, c, s, v, reverse=rev, sign=sign)
                torch.cuda.synchronize()
                err = (got - want).abs().max().item()
                rel = err / want.abs().max().item()
                worst_abs = max(worst_abs, err)
                run = lambda: ckb_cuda.fold(spec.ckb, c, s, v, reverse=rev, sign=sign)  # noqa: E731
                ms, call = device_ms(run), median_ms(run)
                plain = device_ms(lambda: ckb.fold(spec.ckb, c, s, v, reverse=rev, sign=sign),
                                  reps=10)
                say("kernel", dtype=str(dtype).split(".")[1], shape="x".join(map(str, shape)),
                    direction=name, max_rel_err=f"{rel:.3e}", tol=tol, max_abs_err=f"{err:.3e}",
                    kernel_ms=f"{ms:.4f}", call_ms=f"{call:.4f}", plain_ms=f"{plain:.4f}")
                if not rel <= tol:
                    raise RuntimeError(f"kernel disagrees with the plain twin: {rel} > {tol}")
                if dtype == torch.float32 and shape[0] == 32 and name == "forward":
                    # 2 reads/writes per element; 3 flops per element per group
                    b_ms, b_by = bound(2 * v.numel() * v.element_size(),
                                       3 * v.numel() * spec.ckb.ngroups)
                    main = dict(ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                                library_ms=library_ms(spec.ckb, c, s, v))
    return dict(max_abs_err=worst_abs, **main)


def phase_fused_vs_twin() -> dict:
    """K2 and its plain twin on the same inputs, the step's result and the
    Chebyshev sum it adds into: the Holstein 64×64 cell's Chebyshev block
    [32 chains, 2 spins, 4096, 2Lω = 40] and 16 chains × nᵥ = 10
    Green's-function rows; per-chain a, b and pre (forward) or post
    (reverse) diagonals; the forms of a pass's first step (no prev, the sum
    set) and of the others (prev, the sum read and added to). The twin's
    time (``plain_ms``) is the step and the sum written out in PyTorch on
    the card: the one-order A/B of the fusion."""
    from elphdynamics_tpu_torch.ops import checkerboard as ckb
    from elphdynamics_tpu_torch.ops import ckb_cuda

    spec, params = _spec_64()
    N = spec.Nsites
    g = torch.Generator(device="cuda").manual_seed(1)
    worst_abs = 0.0
    main = {}
    for dtype, tol in ((torch.float32, F32_TOL), (torch.float64, F64_TOL)):
        c, s = params.cosht.to(dtype), params.sinht.to(dtype)
        for C, inner in ((32, 2), (16, 10)):
            shape = (C, inner, N, 40)
            v = torch.randn(shape, generator=g, dtype=dtype, device="cuda")
            prev = torch.randn(shape, generator=g, dtype=dtype, device="cuda")
            diag = 0.5 + torch.rand((C, N), generator=g, dtype=dtype, device="cuda")
            a = 0.5 + torch.rand(C, generator=g, dtype=dtype, device="cuda")
            b = torch.rand(C, generator=g, dtype=dtype, device="cuda") - 0.5
            for name, rev in (("forward", False), ("reverse", True)):
                for use_prev in (False, True):
                    acc0, sum_kw = _k2_operands(v, g, init=not use_prev)
                    kw = dict(reverse=rev, pre=None if rev else diag, post=diag if rev else None,
                              a=a, b=b, c=-1.0, prev=prev if use_prev else None, **sum_kw)
                    rel, err = _errors(_outputs(ckb_cuda.fold_fused, spec.ckb, c, s, v, kw, acc0),
                                       _outputs(ckb.fold_fused, spec.ckb, c, s, v, kw, acc0))
                    worst_abs = max(worst_abs, err)
                    timed = kw | dict(acc=acc0.clone())
                    run = lambda: ckb_cuda.fold_fused(spec.ckb, c, s, v, **timed)  # noqa: E731
                    ms, call = device_ms(run), median_ms(run)
                    plain = device_ms(lambda: ckb.fold_fused(spec.ckb, c, s, v, **timed),
                                      reps=10)
                    say("fused_kernel", dtype=str(dtype).split(".")[1],
                        shape="x".join(map(str, shape)), direction=name, prev=use_prev,
                        init=sum_kw["init"], max_rel_err=f"{rel:.3e}", tol=tol,
                        max_abs_err=f"{err:.3e}", kernel_ms=f"{ms:.4f}", call_ms=f"{call:.4f}",
                        plain_ms=f"{plain:.4f}")
                    if not rel <= tol:
                        raise RuntimeError(f"fused kernel disagrees with its twin: {rel} > {tol}")
                    if dtype == torch.float32 and C == 32 and not rev and use_prev:
                        # v, prev and acc read, o and acc written once, and the
                        # coefficient row; per element 3 flops per group plus
                        # pre, the 5-flop combine and the 4-flop sum
                        b_ms, b_by = bound((5 * v.numel() + C * 40) * v.element_size(),
                                           (3 * spec.ckb.ngroups + 10) * v.numel())
                        main = dict(ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                                    library_ms=library_ms(spec.ckb, c, s, v))
    return dict(max_abs_err=worst_abs, **main)


def _ssh_64():
    """The SSH model of ``bench.SSH_64X64`` on the card (float64) and the
    coefficient tables of a tied random field: per (chain, bond, τ)
    ``[8, 8192, 40]`` (the fermion operator's) and their per-chain τ-means
    ``[8, 8192]`` (Ā's)."""
    from elphdynamics_tpu_torch.bench import SSH_64X64, build_ssh_step
    from elphdynamics_tpu_torch.models import ssh as Sm

    b = build_ssh_step(SSH_64X64.L, SSH_64X64.beta, SSH_64X64.dtau, SSH_64X64.dt,
                       SSH_64X64.n_chains, "cuda", torch.float64)
    spec = b.ops.spec
    g = torch.Generator(device="cuda").manual_seed(7)
    x = Sm.tie_fields(spec, b.state.x + 0.3 * torch.randn(b.state.x.shape, generator=g,
                                                            dtype=torch.float64, device="cuda"))
    d = Sm.ckb_coeffs(spec, b.params, x)
    return spec, {"column": (d.cosh, d.sinh), "chain": (d.cosh.mean(-1), d.sinh.mean(-1))}


def phase_table_kernels() -> dict:
    """Both kernels with the SSH model's coefficient tables against their
    twins at the SSH 64×64 update's shapes (C = 8 chains, N = 4096, Lτ =
    2Lω = 40): K1 with per-(chain, bond, τ) tables on the fermion operator's
    [8, 2, N, 40]; K1 with per-chain tables on the power iteration's
    [8, N, 1] and on a CG block [8, 2, N, 40]; K2 with per-chain tables on
    the Chebyshev block [8, 2, N, 40] (the SSH cell's), with prev adding
    into the Chebyshev sum and without prev setting it, both checked.
    Returns, per kernel and mode, its numbers at its main-path shape
    (float32)."""
    from elphdynamics_tpu_torch.ops import checkerboard as ckb
    from elphdynamics_tpu_torch.ops import ckb_cuda

    spec, tables = _ssh_64()
    sc, G = spec.ckb, spec.ckb.ngroups
    C, N, Lt = tables["column"][0].shape[0], spec.Nsites, spec.Ltau
    cases = [("fold", "column", (C, 2, N, Lt)), ("fold", "chain", (C, N, 1)),
             ("fold", "chain", (C, 2, N, Lt)), ("fused", "chain", (C, 2, N, Lt))]
    main_shape = {"fold/column": (C, 2, N, Lt), "fold/chain": (C, N, 1),
                  "fused/chain": (C, 2, N, Lt)}
    g = torch.Generator(device="cuda").manual_seed(8)
    out = {k: dict(max_abs_err=0.0) for k in main_shape}
    for dtype, tol in ((torch.float32, F32_TOL), (torch.float64, F64_TOL)):
        for kernel, form, shape in cases:
            key = f"{kernel}/{form}"
            c, s = (t.to(dtype).contiguous() for t in tables[form])
            v = torch.randn(shape, generator=g, dtype=dtype, device="cuda")
            acc0 = None
            if kernel == "fold":
                variants = [(name, dict(reverse=rev, sign=sign)) for name, rev, sign in DIRECTIONS]
                fast, plain_fn = ckb_cuda.fold, ckb.fold
            else:
                prev = torch.randn(shape, generator=g, dtype=dtype, device="cuda")
                diag = 0.5 + torch.rand((C, N), generator=g, dtype=dtype, device="cuda")
                a = 0.5 + torch.rand(C, generator=g, dtype=dtype, device="cuda")
                bb = torch.rand(C, generator=g, dtype=dtype, device="cuda") - 0.5
                acc0, sum_kw = _k2_operands(v, g)
                variants = [(f"{name}{'_prev' if p else '_init'}",
                             dict(reverse=rev, pre=None if rev else diag,
                                  post=diag if rev else None, a=a, b=bb, c=-1.0,
                                  prev=prev if p else None, **(sum_kw | dict(init=not p))))
                            for name, rev in (("forward", False), ("reverse", True))
                            for p in (True, False)]
                fast, plain_fn = ckb_cuda.fold_fused, ckb.fold_fused
            for name, kw in variants:
                rel, err = _errors(_outputs(fast, sc, c, s, v, kw, acc0),
                                   _outputs(plain_fn, sc, c, s, v, kw, acc0))
                out[key]["max_abs_err"] = max(out[key]["max_abs_err"], err)
                timed = kw if acc0 is None else kw | dict(acc=acc0.clone())
                run = lambda: fast(sc, c, s, v, **timed)  # noqa: E731
                ms, call = device_ms(run), median_ms(run)
                plain = device_ms(lambda: plain_fn(sc, c, s, v, **timed), reps=10)
                # each input read once, each output written once: the field (and
                # prev), the tables, K2's diagonal, scalars, coefficient row and
                # sum (read unless set); 3 flops per element per group (K2: plus
                # the diagonal, the combine and the 4-flop sum)
                moves = 2 + (kw.get("prev") is not None)
                if kernel == "fused":
                    moves += 1 if kw["init"] else 2
                nbytes = v.element_size() * (
                    moves * v.numel() + c.numel() + s.numel()
                    + (C * N + 2 * C + C * shape[-1] if kernel == "fused" else 0))
                flops = (3 * G + (10 if kernel == "fused" else 0)) * v.numel()
                b_ms, b_by = bound(nbytes, flops)
                # the one-call library form, once per float32 shape (per-column
                # tables at their main shape only: C·Lτ dense matrices of N²
                # elements, 21.5 GB)
                lib = (library_ms(sc, c, s, v)
                       if dtype == torch.float32 and form == "chain" and name == "forward" else None)
                if (dtype == torch.float32 and form == "column" and name == "forward"
                        and shape == main_shape[key]):
                    lib = library_ms_columns(sc, c, s, v)
                say("table_kernel", kernel=kernel, tables=form, dtype=str(dtype).split(".")[1],
                    shape="x".join(map(str, shape)), table_shape="x".join(map(str, c.shape)),
                    direction=name, max_rel_err=f"{rel:.3e}", tol=tol, max_abs_err=f"{err:.3e}",
                    kernel_ms=f"{ms:.4f}", call_ms=f"{call:.4f}", plain_ms=f"{plain:.4f}",
                    bound_ms=f"{b_ms:.4f}", bound_share=f"{b_ms / ms:.3f}",
                    **({} if lib is None else {"library_ms": f"{lib:.4f}"}))
                if not rel <= tol:
                    raise RuntimeError(f"{key} kernel disagrees with its twin: {rel} > {tol}")
                if (dtype == torch.float32 and shape == main_shape[key] and "ms" not in out[key]
                        and name.startswith("forward")):
                    if lib is None and form == "chain":
                        lib = library_ms(sc, c, s, v)
                    out[key].update(ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                                    library_ms=lib, shape="x".join(map(str, shape)))
    return out


def phase_small_ssh_reference() -> None:
    """One 4×4 SSH update in float64 on the card with the dense Ā switched
    off (so K1 runs with per-(chain, bond, τ) and per-chain tables and K2
    with per-chain tables), against the same update on the CPU (plain
    twins)."""
    from elphdynamics_tpu_torch.bench import build_ssh_step
    from elphdynamics_tpu_torch.dynamics.hmc import HMCState, draw
    from elphdynamics_tpu_torch.ops import ckb_cuda, kpm

    runs = {}
    dense_max = kpm._DENSE_ABAR_MAX_SITES
    kpm._DENSE_ABAR_MAX_SITES = 0
    try:
        for dev in ("cpu", "cuda"):
            b = build_ssh_step(4, 1.0, 0.1, 0.05, 4, dev, torch.float64, trajectory_time=0.2)
            if dev == "cpu":
                draws = draw(b.ops, 4, torch.float64, "cpu", torch.Generator().manual_seed(1))
                x0 = b.state.x
            moved = replace(draws, momentum=draws.momentum.to(dev),
                            pseudofermion=draws.pseudofermion.to(dev),
                            uniform=draws.uniform.to(dev))
            ckb_cuda.reset_counts()
            st, stats = b.step(b.params, HMCState(x=x0.to(dev), v=torch.zeros_like(x0, device=dev)),
                               draws=moved)
            runs[dev] = (st.x.cpu(), stats.delta_H.cpu(), stats.accepted.cpu(),
                         dict(ckb_cuda.table_launches))
    finally:
        kpm._DENSE_ABAR_MAX_SITES = dense_max
    dx = (runs["cuda"][0] - runs["cpu"][0]).abs().max().item()
    ddh = (runs["cuda"][1] - runs["cpu"][1]).abs().max().item()
    n = runs["cuda"][3]
    say("small_ssh_reference", max_abs_dx=f"{dx:.3e}", max_abs_ddH=f"{ddh:.3e}",
        accept_equal=bool(torch.equal(runs["cuda"][2], runs["cpu"][2])),
        cuda_launches=n, cpu_launches=sum(runs["cpu"][3].values()))
    if not (dx <= 1e-10 and ddh <= 1e-9 and torch.equal(runs["cuda"][2], runs["cpu"][2])
            and n["fold/column"] > 0 and n["fold/chain"] > 0 and n["fused/chain"] > 0
            and sum(runs["cpu"][3].values()) == 0):
        raise RuntimeError("the card's SSH update disagrees with the CPU reference")


def phase_small_fused_reference() -> None:
    """A 4×4 float64 preconditioner apply on the fold branch (the state's
    dense Ā dropped, as tests/test_kpm.py forces it): K2 on the card against
    the plain twin on the CPU, same state and field."""
    from elphdynamics_tpu_torch.bench import build_bench_step
    from elphdynamics_tpu_torch.ops import ckb_cuda, kpm

    cfg = kpm.KPMConfig(max_order=8)
    start = kpm.start_vectors(16, seed=3)
    x = 0.3 * torch.randn((4, 16, 10), generator=torch.Generator().manual_seed(2),
                          dtype=torch.float64)
    v = torch.randn((4, 2, 16, 10), generator=torch.Generator().manual_seed(3),
                    dtype=torch.float64)
    out = {}
    for dev in ("cpu", "cuda"):
        b = build_bench_step(4, 1.0, 0.1, 0.05, 4, dev, torch.float64)
        st = kpm.setup(b.ops, b.params, x.to(dev), cfg, start)
        st = replace(st, expK=None, expK_inv=None)
        before = ckb_cuda.fused_launches
        out[dev] = (kpm.apply_symmetric(b.ops, st, v.to(dev), cfg).cpu(),
                    ckb_cuda.fused_launches - before)
    diff = (out["cuda"][0] - out["cpu"][0]).abs().max().item()
    rel = diff / out["cpu"][0].abs().max().item()
    say("small_fused_reference", max_abs_diff=f"{diff:.3e}", max_rel_diff=f"{rel:.3e}",
        tol=1e-12, cuda_fused_launches=out["cuda"][1], cpu_fused_launches=out["cpu"][1])
    if not (rel <= 1e-12 and out["cuda"][1] > 0 and out["cpu"][1] == 0):
        raise RuntimeError("the card's fold-branch preconditioner disagrees with the CPU")


def phase_chebyshev_ab() -> dict:
    """The fold-branch Chebyshev pair of one preconditioner apply (Āᵀ pass,
    then Ā) on the kernel-64×64 KPM state and a CG-shaped [16, 2, 4096, 40]
    field, through K2 steps and through K1 plus elementwise passes, timed in
    turns (composed, fused, fused, composed)."""
    from elphdynamics_tpu_torch.bench import KERNEL_64X64, build
    from elphdynamics_tpu_torch.ops import kpm

    b = build(KERNEL_64X64, "cuda", torch.float32)
    cfg = kpm.KPMConfig(max_order=4)
    st = kpm.setup(b.ops, b.params, b.state.x, cfg, kpm.start_vectors(b.ops.Nsites))
    if st.expK is not None:
        raise RuntimeError("the 64x64 KPM state is not on the fold branch")
    Lw = (b.ops.Ltau + 1) // 2
    w = torch.randn((16, 2, b.ops.Nsites, 2 * Lw), generator=torch.Generator(device="cuda")
                    .manual_seed(4), device="cuda")

    def pair(fn):
        u = fn(b.ops, st, w, st.coeff.conj_physical(), True)
        return fn(b.ops, st, u, st.coeff, False)

    fused = pair(kpm._chebyshev_apply_stacked_fused)
    composed = pair(kpm._chebyshev_apply_stacked_composed)
    rel = ((fused - composed).abs().max() / composed.abs().max()).item()
    times = {"composed": [], "fused": []}
    for route in ("composed", "fused", "fused", "composed"):
        fn = getattr(kpm, f"_chebyshev_apply_stacked_{route}")
        times[route].append(median_ms(lambda: pair(fn), reps=10))
    apply_ms = median_ms(lambda: kpm.apply_symmetric(b.ops, st, w[..., :b.ops.Ltau], cfg),
                         reps=10)
    out = dict(fused_ms=statistics.mean(times["fused"]),
               composed_ms=statistics.mean(times["composed"]), max_rel_diff=rel,
               apply_symmetric_ms=apply_ms)
    say("chebyshev_ab_64x64", shape="16x2x4096x40", max_order=4,
        fused_ms=f"{out['fused_ms']:.4f}", composed_ms=f"{out['composed_ms']:.4f}",
        fused_runs=",".join(f"{t:.4f}" for t in times["fused"]),
        composed_runs=",".join(f"{t:.4f}" for t in times["composed"]),
        max_rel_diff=f"{rel:.3e}", apply_symmetric_fused_ms=f"{apply_ms:.4f}")
    if not rel <= 1e-4:
        raise RuntimeError(f"the two recurrences disagree: {rel}")
    return out


def phase_small_reference() -> None:
    """One 4×4 update in float64 on the card with the kernel forced on
    (pallas_threshold=0), against the same update on the CPU (plain twin)."""
    from elphdynamics_tpu_torch.bench import build_bench_step
    from elphdynamics_tpu_torch.dynamics.hmc import HMCState, draw
    from elphdynamics_tpu_torch.ops import ckb_cuda

    runs = {}
    for dev in ("cpu", "cuda"):
        b = build_bench_step(4, 1.0, 0.1, 0.05, 4, dev, torch.float64, trajectory_time=0.2,
                             dense_threshold=0, pallas_threshold=0)
        if dev == "cpu":
            draws = draw(b.ops, 4, torch.float64, "cpu", torch.Generator().manual_seed(1))
            x0 = b.state.x
        moved = replace(draws, momentum=draws.momentum.to(dev),
                        pseudofermion=draws.pseudofermion.to(dev),
                        uniform=draws.uniform.to(dev))
        before = ckb_cuda.launches
        st, stats = b.step(b.params, HMCState(x=x0.to(dev), v=torch.zeros_like(x0, device=dev)),
                           draws=moved)
        runs[dev] = (st.x.cpu(), stats.delta_H.cpu(), stats.accepted.cpu(),
                     ckb_cuda.launches - before)
    dx = (runs["cuda"][0] - runs["cpu"][0]).abs().max().item()
    ddh = (runs["cuda"][1] - runs["cpu"][1]).abs().max().item()
    say("small_reference", max_abs_dx=f"{dx:.3e}", max_abs_ddH=f"{ddh:.3e}",
        accept_equal=bool(torch.equal(runs["cuda"][2], runs["cpu"][2])),
        cuda_kernel_launches=runs["cuda"][3], cpu_kernel_launches=runs["cpu"][3])
    if not (dx <= 1e-10 and ddh <= 1e-9 and torch.equal(runs["cuda"][2], runs["cpu"][2])
            and runs["cuda"][3] > 0 and runs["cpu"][3] == 0):
        raise RuntimeError("the card's update disagrees with the CPU reference")


@contextlib.contextmanager
def _without_dense_abar():
    """The KPM's dense-Ā gate closed, so that Ā runs through the fold (K2
    on the card) at any size."""
    from elphdynamics_tpu_torch.ops import kpm

    dense_max = kpm._DENSE_ABAR_MAX_SITES
    kpm._DENSE_ABAR_MAX_SITES = 0
    try:
        yield
    finally:
        kpm._DENSE_ABAR_MAX_SITES = dense_max


MODES = {"holstein": ("fold/shared", "fused/shared"),
         "ssh": ("fold/column", "fold/chain", "fused/chain")}


def phase_small_langevin_reference() -> None:
    """One Euler, one Runge-Kutta and one Heun step of the 4×4 Holstein and
    SSH models in float64 on the card (K1 forced on, the dense Ā off, so K2
    runs; the graphed step, its replays > 0) against the same step on the
    CPU (plain twins, the segments run directly), with the same injected
    draws."""
    from elphdynamics_tpu_torch.bench import build_langevin_step
    from elphdynamics_tpu_torch.dynamics import langevin as tl
    from elphdynamics_tpu_torch.ops import ckb_cuda

    with _without_dense_abar():
        for model in ("holstein", "ssh"):
            for method in tl.METHODS:
                runs = {}
                for dev in ("cpu", "cuda"):
                    b = build_langevin_step(4, 1.0, 0.1, 0.01, 4, dev, torch.float64, model=model,
                                            method=method, dense_threshold=0, pallas_threshold=0)
                    if dev == "cpu":
                        draws = tl.draw(b.ops, 4, method, torch.float64, "cpu",
                                        torch.Generator().manual_seed(1))
                        x0 = b.x
                    moved = tl.LangevinDraws(eta=draws.eta.to(dev),
                                             g=tuple(g.to(dev) for g in draws.g))
                    ckb_cuda.reset_counts()
                    with counting_replays() as replays:
                        x1, stats = b.step(b.params, x0.to(dev), draws=moved)
                    runs[dev] = (x1.cpu(), stats.iters.cpu(), stats.flag.cpu(),
                                 dict(ckb_cuda.table_launches), replays["n"])
                dx = (runs["cuda"][0] - runs["cpu"][0]).abs().max().item()
                n = runs["cuda"][3]
                say("small_langevin_reference", model=model, method=method,
                    max_abs_dx=f"{dx:.3e}", tol=1e-10, iters=runs["cuda"][1].tolist(),
                    iters_equal=bool(torch.equal(runs["cuda"][1], runs["cpu"][1])),
                    cuda_launches=n, cpu_launches=sum(runs["cpu"][3].values()),
                    graph_replays=runs["cuda"][4])
                if not (dx <= 1e-10 and int(runs["cuda"][2].max()) == 0 and runs["cuda"][4] > 0
                        and int(runs["cpu"][2].max()) == 0
                        and all(n[m] > 0 for m in MODES[model])
                        and sum(runs["cpu"][3].values()) == 0):
                    raise RuntimeError(f"the card's {model} {method} Langevin step disagrees "
                                       "with the CPU reference")


def phase_small_solver_reference() -> None:
    """``solve_minv`` and ``solve_oinv`` by GMRES and by BiCGStab with the
    left and right KPM applies, and a block-CG probe solve, on the 4×4
    Holstein model in float64: the card (K1 forced on, Ā through K2)
    against the CPU, same fields and right-hand sides."""
    from elphdynamics_tpu_torch.bench import build_langevin_step
    from elphdynamics_tpu_torch.dynamics.solve import (
        SolverConfig, resolve_precond, solve_minv, solve_oinv)
    from elphdynamics_tpu_torch.ops import ckb_cuda, kpm

    g = torch.Generator().manual_seed(5)
    x = 0.3 * torch.randn((4, 16, 10), generator=g, dtype=torch.float64)
    rhs = torch.randn((4, 3, 16, 10), generator=g, dtype=torch.float64)
    kw = dict(tol=1e-11, maxiter=400, restart=20)
    cases = [(f"{fn.__name__}/{kind}", fn, SolverConfig(kind=kind, **kw), {})
             for kind in ("gmres", "bicgstab") for fn in (solve_minv, solve_oinv)]
    cases.append(("solve_minv/block_cg", solve_minv, SolverConfig(block=True, **kw),
                  dict(block=True)))
    out = {}
    with _without_dense_abar():
        for dev in ("cpu", "cuda"):
            b = build_langevin_step(4, 1.0, 0.1, 0.01, 4, dev, torch.float64,
                                    dense_threshold=0, pallas_threshold=0)
            precond = kpm.make_precond(b.ops, kpm.KPMConfig(max_order=32, c1=4.0, c2=4.0))
            xd = x.to(dev)
            ds = b.ops.stack(b.ops.derived(b.params, xd))
            pa = resolve_precond(precond, b.params, xd)
            for name, fn, scfg, extra in cases:
                ckb_cuda.reset_counts()
                res = fn(b.ops, b.params, ds, rhs.to(dev), scfg, pa, **extra)
                out[name, dev] = (res.x.cpu(), res.iters.cpu(), int(res.flag.max()),
                                  ckb_cuda.launches, ckb_cuda.fused_launches)
    for name, _, _, _ in cases:
        (xc, ic, fc, k1c, k2c), (xg, ig, fg, k1g, k2g) = out[name, "cpu"], out[name, "cuda"]
        rel = ((xg - xc).abs().max() / xc.abs().max()).item()
        say("small_solver_reference", solve=name, max_rel_dx=f"{rel:.3e}", tol=1e-10,
            iters_cuda=f"{ig.double().mean().item():.2f}", iters_cpu=f"{ic.double().mean().item():.2f}",
            flags=(fc, fg), cuda_launches=(k1g, k2g), cpu_launches=(k1c, k2c))
        if not (rel <= 1e-10 and fc == 0 and fg == 0 and k1g > 0 and k2g > 0
                and k1c == 0 and k2c == 0):
            raise RuntimeError(f"{name}: the card disagrees with the CPU reference")


def run_langevin_config(cfg, warmup: int, timed: int) -> dict:
    """Build the Langevin configuration ``cfg`` on the card in float32 and
    run warm-up + timed steps (the graphed step: the warm-up captures, the
    timed steps replay)."""
    from elphdynamics_tpu_torch.bench import build
    from elphdynamics_tpu_torch.ops import ckb_cuda

    t0 = time.perf_counter()
    b = build(cfg, "cuda", torch.float32)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    x = b.x
    for _ in range(warmup):
        x, stats = b.step(b.params, x, b.generator)
    torch.cuda.synchronize()
    ckb_cuda.reset_counts()
    iters, flags = [], []
    with counting_replays() as replays:
        t0 = time.perf_counter()
        for _ in range(timed):
            x, stats = b.step(b.params, x, b.generator)
            iters.append(stats.iters)
            flags.append(stats.flag)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
    by_table = dict(ckb_cuda.table_launches)
    iters, flags = torch.stack(iters).cpu(), torch.stack(flags).cpu()
    out = dict(steps_per_s=cfg.n_chains * timed / elapsed, s_per_step=elapsed / timed,
               method=cfg.method, cg_iters_per_solve=iters.double().mean().item(),
               max_flag=int(flags.max()),
               launches_per_step={k: v / timed for k, v in by_table.items() if v},
               table_launches=by_table, build_s=build_s, seconds=elapsed,
               graph_replays=replays["n"], x_shape=tuple(x.shape),
               x_finite=bool(torch.isfinite(x).all()))
    say(cfg.name, chains=cfg.n_chains, L=cfg.L, timed_steps=timed,
        **{k: (f"{v:.6g}" if isinstance(v, float) else v) for k, v in out.items()})
    out["launch_shapes"] = set(ckb_cuda.launch_shapes)
    shape = (cfg.n_chains, b.ops.Nph, round(cfg.beta / cfg.dtau))
    idle = [m for m in MODES[cfg.model] if by_table[m] <= 0]
    if not (out["x_finite"] and out["x_shape"] == shape) or out["max_flag"] != 0 or idle:
        raise RuntimeError(f"{cfg.name}: non-finite or misshapen output, flag "
                           f"{out['max_flag']}, or kernel modes launched no time: {idle}")
    # the one-rank CG step of a real field is the graphed one (dynamics/langevin.py)
    if b.step.segmented and cfg.twist is None and replays["n"] <= 0:
        raise RuntimeError(f"{cfg.name}: the graphed Langevin step replayed no graph")
    return out


def phase_solver_kinds_64() -> dict:
    """nᵥ = 10 probe solves per chain of M·z = r on the kernel 64×64 model
    (16 chains, float32, KPM max_order 4) by CG on MᵀM and block CG over
    each chain's probes: iterations, seconds, flags, launches, and the
    relative distance between the two kinds' solutions (CG's is returned
    as ``cg_x``: phase 43 holds GMRES's and BiCGStab's to it)."""
    from elphdynamics_tpu_torch.bench import LANGEVIN_64X64, build
    from elphdynamics_tpu_torch.dynamics.solve import SolverConfig, resolve_precond, solve_minv
    from elphdynamics_tpu_torch.ops import ckb_cuda

    b = build(LANGEVIN_64X64, "cuda", torch.float32)
    ops, x = b.ops, b.x
    R = torch.randn((x.shape[0], 10, ops.Nsites, ops.Ltau), device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(6))
    ds = ops.stack(ops.derived(b.params, x))
    pa = resolve_precond(b.precond, b.params, x)
    kw = dict(tol=1e-5, maxiter=500)
    kinds = {"cg": (SolverConfig(**kw), False), "block_cg": (SolverConfig(block=True, **kw), True)}
    sols, out, shapes = {}, {}, set()
    for name, (scfg, block) in kinds.items():
        for timed in (False, True):      # the first pass tunes the launch geometries
            ckb_cuda.reset_counts()
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = solve_minv(ops, b.params, ds, R, scfg, pa, block=block)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        sols[name] = res.x
        shapes |= set(ckb_cuda.launch_shapes)
        out[name] = dict(iters=res.iters.double().mean().item(), max_iters=int(res.iters.max()),
                         seconds=secs, max_flag=int(res.flag.max()),
                         max_residual=res.residual.max().item(),
                         k1_launches=ckb_cuda.launches, k2_launches=ckb_cuda.fused_launches,
                         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
        say("solver_kinds_64x64", kind=name, systems=R.shape[0] * R.shape[1],
            **{k: (f"{v:.6g}" if isinstance(v, float) else v) for k, v in out[name].items()})

    def norm(a):
        return a.double().pow(2).sum(dim=(-2, -1)).sqrt()

    dist = max((norm(sols[a] - sols[b2]) / norm(sols["cg"])).max().item()
               for a in kinds for b2 in kinds if a < b2)
    say("solver_kinds_64x64", max_mutual_distance=f"{dist:.3e}", tol=kw["tol"], gate=1e-3)
    bad = [k for k, v in out.items()
           if v["max_flag"] != 0 or v["k1_launches"] <= 0 or v["k2_launches"] <= 0]
    if bad or not dist <= 1e-3:
        raise RuntimeError(f"64x64 solver kinds: flagged or idle {bad}, distance {dist}")
    out["launch_shapes"] = shapes
    out["cg_x"] = sols["cg"]
    return out


def run_config(cfg, warmup: int, timed: int) -> dict:
    """Build ``cfg`` on the card in float32 and run warm-up + timed updates."""
    from elphdynamics_tpu_torch.bench import build
    from elphdynamics_tpu_torch.ops import ckb_cuda

    t0 = time.perf_counter()
    b = build(cfg, "cuda", torch.float32)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    ckb_cuda.reset_counts()
    state = b.state
    exchanges = []

    def update(n):
        """Update ``n`` (from 1), and under a ladder an exchange attempt
        every ``exchange_freq`` updates, the pair parity alternating."""
        state_, stats_ = b.step(b.params, state, b.generator)
        if b.exchange is not None and n % b.exchange_freq == 0:
            x, v, rate, _, flag = b.exchange(b.params, state_.x, state_.v,
                                             (n // b.exchange_freq) % 2, b.generator)
            state_ = replace(state_, x=x, v=v)
            exchanges.append((rate, flag))
        return state_, stats_

    with counting_replays() as replays:
        for n in range(1, warmup + 1):
            state, stats = update(n)
        torch.cuda.synchronize()
        acc, iters, flags, dHs = [], [], [], []
        t0 = time.perf_counter()
        for n in range(warmup + 1, warmup + timed + 1):
            state, stats = update(n)
            acc.append(stats.accepted)
            iters.append(stats.iters)
            flags.append(stats.flag)
            dHs.append(stats.delta_H)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
    launches, fused_launches = ckb_cuda.launches, ckb_cuda.fused_launches
    by_table = dict(ckb_cuda.table_launches)
    acc, iters, flags, dHs = (torch.stack(a).cpu() for a in (acc, iters, flags, dHs))
    out = dict(sweeps_per_s=cfg.n_chains * timed / elapsed,
               acceptance=acc.double().mean().item(),
               cg_iters_per_solve=iters.double().mean().item(),
               max_flag=int(flags.max()), dH_finite=bool(torch.isfinite(dHs).all()),
               max_abs_dH=dHs.abs().max().item(), kernel_launches=launches,
               fused_kernel_launches=fused_launches, table_launches=by_table,
               build_s=build_s, seconds=elapsed, graph_replays=replays["n"],
               x_shape=tuple(state.x.shape), x_finite=bool(torch.isfinite(state.x).all()))
    if exchanges:
        out.update(exchanges=len(exchanges),
                   exchange_acceptance=statistics.mean(float(r) for r, _ in exchanges),
                   exchange_max_flag=max(int(f) for _, f in exchanges))
        out["max_flag"] = max(out["max_flag"], out["exchange_max_flag"])
    say(cfg.name, chains=cfg.n_chains, L=cfg.L, timed_updates=timed,
        **{k: (f"{v:.6g}" if isinstance(v, float) else v) for k, v in out.items()})
    out.update(launch_shapes=set(ckb_cuda.launch_shapes), x=state.x.cpu(), accepted=acc,
               exchange_rates=[(float(r), int(f)) for r, f in exchanges])
    shape = (cfg.n_chains, b.ops.Nph, round(cfg.beta / cfg.dtau))
    if not (out["x_finite"] and out["dH_finite"] and out["x_shape"] == shape):
        raise RuntimeError(f"{cfg.name}: non-finite or misshapen output")
    # a graphed configuration (real or complex hopping) must have replayed graphs
    if getattr(b.step, "segmented", False) and replays["n"] <= 0:
        raise RuntimeError(f"{cfg.name}: the graphed update replayed no graph")
    return out


def run_driver(name: str, cfg: dict, n_chains: int, workdir: str, extra_files=(),
               failures_ok: int = 0) -> dict:
    """``simulation.simulate`` of ``cfg`` (written as a TOML file, ``[hmc]``
    or ``[langevin]``) on the card in float32, with both kernels' counts
    set to 0 just before and read just after; checks the output tree
    (``extra_files``: further per-bin tables that must be finite) and that
    at most ``failures_ok`` updates were flagged by the solver."""
    from elphdynamics_tpu_torch.io.output import dump_toml
    from elphdynamics_tpu_torch.ops import ckb_cuda
    from elphdynamics_tpu_torch.simulation import simulate

    workdir = os.path.join(workdir, name)
    os.makedirs(workdir)
    cfg["simulation"]["filepath"] = workdir
    path = os.path.join(workdir, f"{name}.toml")
    with open(path, "w") as f:
        f.write(dump_toml(cfg))
    torch.cuda.reset_peak_memory_stats()
    ckb_cuda.reset_counts()
    with counting_replays() as replays:
        t0 = time.perf_counter()
        stats = simulate(path, n_chains=n_chains, device="cuda", dtype=torch.float32)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches, fused_launches = ckb_cuda.launches, ckb_cuda.fused_launches
    by_table, shapes = dict(ckb_cuda.table_launches), set(ckb_cuda.launch_shapes)
    sp = cfg["simulation"]
    if "hmc" in cfg:
        h = cfg["hmc"]
        n_burn, n_sim = h["burnin_updates"], h["simulation_updates"]
    else:
        h = cfg["langevin"]
        n_burn, n_sim = h["burnin_timesteps"], h["simulation_timesteps"]
    ssh = "ssh" in cfg
    folder = os.path.join(workdir, f"{sp['foldername']}-1")
    with open(os.path.join(folder, f"{sp['foldername']}_summary.out")) as f:
        summary = f.read()
    sections = ("INPUT FILE CONTENTS", "SIMULATION INFO", "GLOBAL MEASUREMENTS",
                "ON-SITE MEASUREMENTS", "INTER-SITE MEASUREMENTS", "SUSCEPTIBILITIES",
                "CORRELATIONS")
    files = [("global_measurements", "keyed"), ("onsite_measurements", "keyed"),
             ("intersite_measurements", "keyed"), ("Greens_position", "table"),
             ("PairSusc_momentum", "table")]
    if ssh and cfg["measurements"].get("PhononGreens", {}).get("measure", False):
        # the bond phonons' Green's function (inter-site for SSH)
        files += [("PhononGreens_position", "table"), ("PhononGreens_momentum", "table")]
    files += [(sub, "table") for sub in extra_files]
    finite = True
    for b in range(1, sp["num_bins"] + 1):
        for sub, kind in files:
            path = os.path.join(folder, f"{sub}_f", f"{sub}_{b:05d}.out")
            if kind == "keyed":
                with open(path) as f:
                    lines = f.read().splitlines()
                vals = np.asarray([float(r.split()[-1]) for r in lines
                                   if r.split() and r.split()[0] != "measurement"])
            else:
                vals = np.loadtxt(path, skiprows=1)[:, 1:]
            finite = finite and vals.size > 0 and bool(np.isfinite(vals).all())
    n_upd = n_burn + n_sim
    n_meas = n_sim // h["meas_freq"]
    out = dict(chains=n_chains, L=cfg["lattice"]["L"], beta=cfg["ssh" if ssh else "holstein"]["beta"],
               updates=n_upd, measurements=n_meas, wall_s=wall,
               s_per_update=stats["simulation_time"] / n_upd,
               s_per_measurement=stats["measurement_time"] / n_meas,
               write_s=stats["write_time"], acceptance=stats["acceptance_rate"],
               cg_iters_per_solve=stats["iters"], solver_failures=stats.get("solver_failures", 0),
               reflect_acceptance=stats["reflect_acceptance_rate"],
               swap_acceptance=stats["swap_acceptance_rate"],
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
               **{k: stats[k] for k in ("tuned_dt", "tempering_acceptance_rate") if k in stats},
               kernel_launches=launches, fused_kernel_launches=fused_launches,
               table_launches=by_table, graph_replays=replays["n"],
               graph_replays_by_part=stats["graph_replays"],
               sections_ok=(all(f"## {x} ##" in summary for x in sections)
                            and (not ssh or "sign_switch 1 = " in summary)),
               bins_finite=finite)
    say(f"driver_{name}", **{k: (f"{v:.6g}" if isinstance(v, float) else v)
                             for k, v in out.items()})
    out["launch_shapes"] = shapes
    if not (out["sections_ok"] and finite):
        raise RuntimeError(f"driver {name}: summary sections or bins wrong")
    if out["solver_failures"] > failures_ok or not out["acceptance"] > 0:
        raise RuntimeError(f"driver {name}: {out['solver_failures']} solver failures, "
                           f"acceptance {out['acceptance']}")
    return out


def phase_driver(example: str, model: str, small_updates: tuple[int, int, int],
                 big_updates: tuple[int, int, int] = (1, 2, 2)) -> dict:
    """A stock 4×4 example with its counts cut, and the same file at 64×64
    (β = 4, dt = 0.025, 4 bosonic substeps, 4 chains, nᵥ = 10:
    ``bench.wide_hmc_config``): the full-width run, with K1 (fermion
    operator, Ā power iteration) and K2 (Chebyshev steps) on its path.
    ``small_updates`` / ``big_updates``: each run's burn-in updates,
    sampling updates (a measurement after each at 64×64) and bins. Each run
    writes into its own temporary folder; both must replay the graphs of
    the update, the moves the file configures and the measurement."""
    from elphdynamics_tpu_torch.bench import wide_hmc_config

    with open(os.path.join(_examples_dir(), f"{example}.toml"), "rb") as f:
        stock = tomllib.load(f)
    name = example.split("_")[0]
    with tempfile.TemporaryDirectory() as work:
        small = json.loads(json.dumps(stock))
        burnin, sampling, bins = small_updates
        # 20 of the stock 100 leapfrog steps: the 4×4 runs are host-bound
        small["hmc"].update(burnin_updates=burnin, simulation_updates=sampling,
                            trajectory_time=0.2)
        small["simulation"]["num_bins"] = bins
        small_out = run_driver(f"{name}_square_4x4", small, 1, work)
        big = wide_hmc_config(stock)
        big["hmc"].update(burnin_updates=big_updates[0], simulation_updates=big_updates[1])
        big["simulation"]["num_bins"] = big_updates[2]
        out = run_driver(f"{name}_square_64x64", big, 4, work)
    if out["kernel_launches"] <= 0 or out["fused_kernel_launches"] <= 0:
        raise RuntimeError(f"the 64x64 {name} driver run launched a kernel no time: "
                           f"K1 {out['kernel_launches']}, K2 {out['fused_kernel_launches']}")
    # both models' one-card leapfrog CG updates, moves and measurements are
    # graphed (dynamics/graphs.py); SSH's reflection is a null move
    parts = ("update", "swap", "measurement") + (("reflect",) if model == "holstein" else ())
    for run in (small_out, out):
        if any(run["graph_replays_by_part"][p] <= 0 for p in parts):
            raise RuntimeError(f"a {name} driver run replayed no CUDA graph of a part: 4x4 "
                               f"{small_out['graph_replays_by_part']}, 64x64 "
                               f"{out['graph_replays_by_part']}")
    return out


def phase_driver_langevin() -> dict:
    """``examples/holstein_langevin_square.toml`` with its counts cut (4×4,
    dense branch), and the same file at 64×64, β = 4, 4 chains, 1 + 2
    Runge-Kutta steps and one measurement with the bond-pair correlations
    BondBond, CurrentCurrent and BondPairGreens switched on (nᵥ = 10: 45
    probe pairs, 4 bond pairs). BondBond and BondPairGreens are time
    dependent, CurrentCurrent is written at equal time (its transforms run
    over all of τ all the same): the per-bin text files of a time-dependent
    64×64 correlation take seconds each to write."""
    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, "examples", "holstein_langevin_square.toml"), "rb") as f:
        stock = tomllib.load(f)
    with tempfile.TemporaryDirectory() as work:
        small = json.loads(json.dumps(stock))
        small["langevin"].update(burnin_timesteps=2, simulation_timesteps=4, meas_freq=2)
        small["simulation"]["num_bins"] = 2
        small_out = run_driver("langevin_square_4x4", small, 1, work)
        big = json.loads(json.dumps(stock))
        big["lattice"]["L"] = 64
        big["holstein"]["beta"] = 4.0
        big["langevin"].update(burnin_timesteps=1, simulation_timesteps=2, meas_freq=2)
        big["simulation"]["num_bins"] = 1
        big["measurements"]["num_random_vectors"] = 10
        bond = ("BondBond", "CurrentCurrent", "BondPairGreens")
        big["measurements"].update({k: {"measure": True, "time_dependent": k != "CurrentCurrent"}
                                    for k in bond})
        out = run_driver("langevin_square_64x64", big, 4, work,
                         extra_files=[f"{k}_position" for k in bond] + ["BondPairSusc_momentum"])
    if out["kernel_launches"] <= 0 or out["fused_kernel_launches"] <= 0:
        raise RuntimeError("the 64x64 Langevin driver run launched a kernel no time: "
                           f"K1 {out['kernel_launches']}, K2 {out['fused_kernel_launches']}")
    # the one-card CG Langevin step and measurement are graphed
    # (dynamics/langevin.py, measure/measurements.py)
    if min(small_out["graph_replays"], out["graph_replays"],
           *(r["graph_replays_by_part"][p] for r in (small_out, out)
             for p in ("update", "measurement"))) <= 0:
        raise RuntimeError(f"a Langevin driver run replayed no CUDA graph: 4x4 "
                           f"{small_out['graph_replays']}, 64x64 {out['graph_replays']}")
    return out


def phase_path_shapes(paths: dict) -> None:
    """Every (kernel, coefficient form, field shape) that a 64×64 run of
    ``paths`` ({run name: its ``ckb_cuda.launch_shapes``}) launched, against
    the twin on the same inputs: float32 and float64 (K1's complex mode:
    complex64 and complex128, with the twisted models' tables), all four
    directions (K2: forward and reverse, with prev adding into the
    Chebyshev sum and without prev setting it; both outputs), at every
    launch geometry of ``ckb_cuda.launch_candidates`` for that shape, one of
    which the wrapper's tuning keeps. The kernels see a field as rows of
    [N, K] (and, with per-chain operands, chains of rows), so shapes are
    merged to [B, N, K] for K1 with one table and to [C, B/C, N, K]
    otherwise."""
    from elphdynamics_tpu_torch.ops import checkerboard as ckb
    from elphdynamics_tpu_torch.ops import ckb_cuda

    t0 = time.perf_counter()
    users: dict = {}
    for path, shapes in paths.items():
        for form, shape, _ in shapes:
            rows = math.prod(shape[:-2])
            lead = (rows,) if form.startswith("fold/shared") else (shape[0], rows // shape[0])
            users.setdefault((form, lead + tuple(shape[-2:])), set()).add(path)
    models = {False: (_spec_64(), _ssh_64())}
    if any(form.endswith("/complex") for form, _ in users):
        models[True] = (_twisted_64(), _ssh_twisted_64())
    g = torch.Generator(device="cuda").manual_seed(9)
    for (form, shape), by in sorted(users.items()):
        kernel, table = form.split("/")[:2]
        cplx = form.endswith("/complex")
        holstein, ssh = models[cplx]
        C, N = shape[0], shape[-2]
        worst, n_geo = {}, 0
        dtypes = ((torch.complex64, torch.complex128) if cplx
                  else (torch.float32, torch.float64))
        for dtype in dtypes:
            tol = TOLS[dtype]
            if table == "shared":
                sc, (c, s) = holstein[0].ckb, (holstein[1].cosht, holstein[1].sinht)
            else:
                sc, (c, s) = ssh[0].ckb, (t[:C] for t in ssh[1][table])
                if c.shape[0] != C or (table == "column" and c.shape[-1] != shape[-1]):
                    raise RuntimeError(f"no {form} tables for a field of shape {shape}")
            c, s = c.to(dtype).contiguous(), s.to(dtype).contiguous()
            v = torch.randn(shape, generator=g, dtype=dtype, device="cuda")
            acc0 = None
            if kernel == "fold":
                variants = [dict(reverse=rev, sign=sign) for _, rev, sign in DIRECTIONS]
                fast, plain_fn = ckb_cuda.fold, ckb.fold
            else:
                prev = torch.randn(shape, generator=g, dtype=dtype, device="cuda")
                diag = 0.5 + torch.rand((C, N), generator=g, dtype=dtype, device="cuda")
                a = 0.5 + torch.rand(C, generator=g, dtype=dtype, device="cuda")
                b = torch.rand(C, generator=g, dtype=dtype, device="cuda") - 0.5
                acc0, sum_kw = _k2_operands(v, g)
                variants = [dict(reverse=rev, pre=None if rev else diag,
                                 post=diag if rev else None, a=a, b=b, c=-1.0,
                                 prev=prev if p else None, **(sum_kw | dict(init=not p)))
                            for rev in (False, True) for p in (True, False)]
                fast, plain_fn = ckb_cuda.fold_fused, ckb.fold_fused
            cands = ckb_cuda.launch_candidates(
                sc, v, "ckb_fold" if kernel == "fold" else "ckb_fold_fused",
                per_column=table == "column")
            n_geo = len(cands)
            rel = torch.zeros((), dtype=torch.float64, device="cuda")
            for kw in variants:
                want = _outputs(plain_fn, sc, c, s, v, kw, acc0)
                for geo in cands:
                    got = _outputs(fast, sc, c, s, v, kw | dict(geometry=geo), acc0)
                    for x, y in zip(got, want):
                        rel = torch.maximum(rel, ((x - y).abs().max() / y.abs().max()).double())
            worst[dtype] = rel.item()
            if not worst[dtype] <= tol:
                raise RuntimeError(f"{form} at {shape} ({dtype}) disagrees with its twin at one "
                                   f"of {cands}: {worst[dtype]} > {tol}")
        lo, hi = dtypes
        say("path_shape", kernel=kernel, tables=table + ("/complex" if cplx else ""),
            shape="x".join(map(str, shape)), geometries=n_geo,
            **{f"max_rel_err_{str(lo).split('.')[1]}": f"{worst[lo]:.3e}",
               f"tol_{str(lo).split('.')[1]}": TOLS[lo],
               f"max_rel_err_{str(hi).split('.')[1]}": f"{worst[hi]:.3e}",
               f"tol_{str(hi).split('.')[1]}": TOLS[hi]},
            launched_by=",".join(sorted(by)))
    say("path_shapes", checked=len(users), seconds=f"{time.perf_counter() - t0:.2f}")


# ---------------------------------------------------------------------------
# complex hopping (twisted boundaries): K1's complex mode
# ---------------------------------------------------------------------------

COMPLEX_MODES = ("fold/shared/complex", "fold/column/complex", "fold/chain/complex")


def _twisted_64():
    """The twisted Holstein model of ``bench.TWISTED_64X64`` on the card
    (complex128 [Nb] tables), with bond disorder."""
    from elphdynamics_tpu_torch.bench import TWISTED_64X64
    from elphdynamics_tpu_torch.lattice import Lattice, UnitCell
    from elphdynamics_tpu_torch.models.holstein import build_holstein

    uc = UnitCell.create(2, 1, [[1.0, 0.0], [0.0, 1.0]], [[0.0, 0.0]])
    return build_holstein(
        Lattice.create(uc, TWISTED_64X64.L), beta=TWISTED_64X64.beta, dtau=TWISTED_64X64.dtau,
        t_assignments=[(1.0, 0.1, 0, 0, (1, 0, 0)), (1.0, 0.1, 0, 0, (0, 1, 0))],
        twist=TWISTED_64X64.twist, rng=np.random.default_rng(0), device="cuda")


def _ssh_twisted_64():
    """The twisted SSH model of ``bench.SSH_TWISTED_64X64`` on the card
    (float64) and the complex128 tables of a tied random field: per (chain,
    bond, τ) ``[8, 8192, 40]`` and their per-chain τ-means ``[8, 8192]``."""
    from elphdynamics_tpu_torch.bench import SSH_TWISTED_64X64, build
    from elphdynamics_tpu_torch.models import ssh as Sm

    b = build(SSH_TWISTED_64X64, "cuda", torch.float64)
    spec = b.ops.spec
    g = torch.Generator(device="cuda").manual_seed(7)
    x = Sm.tie_fields(spec, b.state.x + 0.3 * torch.randn(b.state.x.shape, generator=g,
                                                            dtype=torch.float64, device="cuda"))
    d = Sm.ckb_coeffs(spec, b.params, x)
    return spec, {"column": (d.cosh, d.sinh), "chain": (d.cosh.mean(-1), d.sinh.mean(-1))}


def phase_complex_kernels() -> dict:
    """K1's complex mode against its twin at the twisted 64×64 shapes,
    complex64 and complex128, all four directions: [Nb] tables (twisted
    Holstein) on the fermion operator's [16, N, 40] and the power
    iteration's [16, N, 1]; per-(chain, bond, column) tables (twisted SSH's
    fermion operator) on [8, 1, N, 40]; per-chain tables (SSH's Ā) on a CG
    block [8, 1, N, 40], the power iteration's [8, N, 1] and a densified Ā
    [8, N, N]. Forward launches are timed (device ms, plain ms, bound);
    returns, per table form, the numbers at its main shape (complex64)."""
    from elphdynamics_tpu_torch.ops import checkerboard as ckb
    from elphdynamics_tpu_torch.ops import ckb_cuda

    hspec, hparams = _twisted_64()
    sspec, stables = _ssh_twisted_64()
    N = hspec.Nsites
    cases = [("shared", (16, N, 40)), ("shared", (16, N, 1)), ("column", (8, 1, N, 40)),
             ("chain", (8, 1, N, 40)), ("chain", (8, N, 1)), ("chain", (8, N, N))]
    main_shape = {"shared": (16, N, 40), "column": (8, 1, N, 40), "chain": (8, 1, N, 40)}
    g = torch.Generator(device="cuda").manual_seed(10)
    out = {f"fold/{form}/complex": dict(max_abs_err=0.0) for form in main_shape}
    for dtype, rate in ((torch.complex64, F32_FLOPS_PER_S), (torch.complex128, F64_FLOPS_PER_S)):
        tol = TOLS[dtype]
        for form, shape in cases:
            key = f"fold/{form}/complex"
            if form == "shared":
                sc, (c, s) = hspec.ckb, (hparams.cosht, hparams.sinht)
            else:
                sc, (c, s) = sspec.ckb, stables[form]
            c, s = c.to(dtype).contiguous(), s.to(dtype).contiguous()
            v = torch.randn(shape, generator=g, dtype=dtype, device="cuda")
            big = v.numel() > 1e8
            for name, rev, sign in DIRECTIONS:
                got = ckb_cuda.fold(sc, c, s, v, reverse=rev, sign=sign)
                want = ckb.fold(sc, c, s, v, reverse=rev, sign=sign)
                torch.cuda.synchronize()
                err = (got - want).abs().max().item()
                rel = err / want.abs().max().item()
                del got, want
                out[key]["max_abs_err"] = max(out[key]["max_abs_err"], err)
                timing = {}
                if name == "forward":
                    run = lambda: ckb_cuda.fold(sc, c, s, v)  # noqa: E731
                    ms = device_ms(run, reps=2 if big else 30, replays=2 if big else 3)
                    plain = device_ms(lambda: ckb.fold(sc, c, s, v), reps=1 if big else 10,
                                      replays=1 if big else 3)
                    # the field read and written once, the tables read once;
                    # 14 real flops per complex element per group
                    b_ms, b_by = bound(v.element_size() * (2 * v.numel() + c.numel() + s.numel()),
                                       14 * sc.ngroups * v.numel(), rate)
                    lib = None
                    if dtype == torch.complex64 and shape == main_shape[form]:
                        lib = (library_ms_columns(sc, c, s, v) if form == "column"
                               else library_ms(sc, c, s, v))
                    timing = dict(kernel_ms=f"{ms:.4f}", plain_ms=f"{plain:.4f}",
                                  bound_ms=f"{b_ms:.4f}", bound_by=b_by,
                                  bound_share=f"{b_ms / ms:.3f}",
                                  **({} if lib is None else {"library_ms": f"{lib:.4f}"}))
                    if dtype == torch.complex64 and shape == main_shape[form]:
                        out[key].update(ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                                        library_ms=lib, shape="x".join(map(str, shape)))
                say("complex_kernel", tables=form, dtype=str(dtype).split(".")[1],
                    shape="x".join(map(str, shape)), table_shape="x".join(map(str, c.shape)),
                    direction=name, max_rel_err=f"{rel:.3e}", tol=tol, max_abs_err=f"{err:.3e}",
                    **timing)
                if not rel <= tol:
                    raise RuntimeError(f"{key} kernel disagrees with its twin: {rel} > {tol}")
    return out


def phase_small_twisted_reference() -> None:
    """Twisted 4×4 float64 runs on the card against the CPU, with the same
    inputs and draws: K1 forced on and the dense Ā off, so every fold of a
    complex field (the fermion operator, the power iteration and the
    complex Chebyshev recurrence) runs K1's complex mode. A Holstein and an
    SSH HMC update, a Holstein Runge-Kutta Langevin step (x within 1e-12,
    equal iterations and accept decisions) and a Holstein measurement
    (every increment within 1e-10 relative)."""
    from elphdynamics_tpu_torch.bench import TWIST, build_bench_step, build_langevin_step, build_ssh_step
    from elphdynamics_tpu_torch.dynamics import langevin as tl
    from elphdynamics_tpu_torch.dynamics.hmc import HMCState, draw
    from elphdynamics_tpu_torch.dynamics.solve import SolverConfig
    from elphdynamics_tpu_torch.measure import measurements as tm
    from elphdynamics_tpu_torch.ops import ckb_cuda
    from elphdynamics_tpu_torch.utils.dtypes import trace_noise

    forced = dict(dense_threshold=0, pallas_threshold=0)
    c128 = torch.complex128
    with _without_dense_abar():
        for model, builder, kw, modes in (
                ("holstein", build_bench_step, forced, ("fold/shared/complex",)),
                ("ssh", build_ssh_step, {}, ("fold/column/complex", "fold/chain/complex"))):
            runs = {}
            for dev in ("cpu", "cuda"):
                b = builder(4, 1.0, 0.1, 0.05, 4, dev, torch.float64, trajectory_time=0.2,
                            twist=TWIST, **kw)
                if dev == "cpu":
                    draws = draw(b.ops, 4, torch.float64, "cpu", torch.Generator().manual_seed(1),
                                 fdtype=c128)
                    x0 = b.state.x
                moved = replace(draws, momentum=draws.momentum.to(dev),
                                pseudofermion=draws.pseudofermion.to(dev),
                                uniform=draws.uniform.to(dev))
                ckb_cuda.reset_counts()
                st, stats = b.step(b.params, HMCState(x=x0.to(dev),
                                                      v=torch.zeros_like(x0, device=dev)),
                                   draws=moved)
                runs[dev] = (st.x.cpu(), stats.iters.cpu(), stats.accepted.cpu(),
                             dict(ckb_cuda.table_launches))
            dx = (runs["cuda"][0] - runs["cpu"][0]).abs().max().item()
            n = runs["cuda"][3]
            say("small_twisted_reference", run=f"{model}_hmc", max_abs_dx=f"{dx:.3e}", tol=1e-12,
                iters=runs["cuda"][1].tolist(),
                iters_equal=bool(torch.equal(runs["cuda"][1], runs["cpu"][1])),
                accept_equal=bool(torch.equal(runs["cuda"][2], runs["cpu"][2])),
                cuda_launches={m: n[m] for m in COMPLEX_MODES},
                cpu_launches=sum(runs["cpu"][3].values()))
            if not (dx <= 1e-12 and torch.equal(runs["cuda"][1], runs["cpu"][1])
                    and torch.equal(runs["cuda"][2], runs["cpu"][2])
                    and all(n[m] > 0 for m in modes) and sum(runs["cpu"][3].values()) == 0):
                raise RuntimeError(f"the card's twisted {model} update disagrees with the CPU")

        runs = {}
        for dev in ("cpu", "cuda"):
            b = build_langevin_step(4, 1.0, 0.1, 0.01, 4, dev, torch.float64, method="rk",
                                    twist=TWIST, **forced)
            if dev == "cpu":
                draws = tl.draw(b.ops, 4, "rk", torch.float64, "cpu",
                                torch.Generator().manual_seed(1), fdtype=c128)
                x0 = b.x
            ckb_cuda.reset_counts()
            x1, stats = b.step(b.params, x0.to(dev), draws=tl.LangevinDraws(
                eta=draws.eta.to(dev), g=tuple(g.to(dev) for g in draws.g)))
            runs[dev] = (x1.cpu(), stats.iters.cpu(), stats.flag.cpu(),
                         ckb_cuda.table_launches["fold/shared/complex"])
        dx = (runs["cuda"][0] - runs["cpu"][0]).abs().max().item()
        say("small_twisted_reference", run="holstein_langevin_rk", max_abs_dx=f"{dx:.3e}",
            tol=1e-12, iters=runs["cuda"][1].tolist(),
            iters_equal=bool(torch.equal(runs["cuda"][1], runs["cpu"][1])),
            cuda_launches=runs["cuda"][3], cpu_launches=runs["cpu"][3])
        if not (dx <= 1e-12 and torch.equal(runs["cuda"][1], runs["cpu"][1])
                and int(runs["cuda"][2].max()) == 0 and runs["cuda"][3] > 0
                and runs["cpu"][3] == 0):
            raise RuntimeError("the card's twisted Langevin step disagrees with the CPU")

    mspec = tm.MeasurementSpec(nv=4, onsite_corr=tuple(
        (k, True) for k in ("Greens", "DenDen", "SpinSpin", "PairGreens")),
        intersite_corr=(("CurrentCurrent", True), ("BondBond", True), ("BondPairGreens", True)))
    x = 0.3 * torch.randn((2, 16, 10), generator=torch.Generator().manual_seed(3),
                          dtype=torch.float64)
    R = trace_noise((2, 4, 16, 10), c128, "cpu", torch.Generator().manual_seed(4))
    incs = {}
    for dev in ("cpu", "cuda"):
        b = build_bench_step(4, 1.0, 0.1, 0.05, 2, dev, torch.float64, twist=TWIST, **forced)
        step = tm.make_measurement_step(b.ops, mspec, SolverConfig(tol=1e-12, maxiter=2000))
        ckb_cuda.reset_counts()
        inc, stats, _ = step(b.params, x.to(dev), R=R.to(dev))
        incs[dev] = ({f"{g}/{k}": v.cpu() for g, vals in inc.items() for k, v in vals.items()},
                     stats["iters"].cpu(), ckb_cuda.table_launches["fold/shared/complex"])
    worst = max(((incs["cuda"][0][k] - v).abs().max() / v.abs().max().clamp(min=1e-300)).item()
                for k, v in incs["cpu"][0].items())
    say("small_twisted_reference", run="holstein_measurement", max_rel_diff=f"{worst:.3e}",
        tol=1e-10, increments=len(incs["cpu"][0]),
        iters_equal=bool(torch.equal(incs["cuda"][1], incs["cpu"][1])),
        cuda_launches=incs["cuda"][2], cpu_launches=incs["cpu"][2])
    if not (worst <= 1e-10 and incs["cuda"][2] > 0 and incs["cpu"][2] == 0):
        raise RuntimeError("the card's twisted measurement disagrees with the CPU")
    _small_twisted_block()


def _small_twisted_block() -> None:
    """Block CG on complex fields (Hermitian block CG), 4×4 float64, card
    against CPU with K1 forced on and the dense Ā off: nᵥ = 4 probe solves
    of M by block CG (tol 1e-10; x within 1e-12 of the CPU's largest entry)
    on the twisted Holstein model, and an HMC update with ``[solver] block``
    (the trajectory solves at s = 1) of the twisted Holstein and SSH models
    (x within 1e-12); equal iterations and decisions."""
    from elphdynamics_tpu_torch.bench import TWIST, build_bench_step, build_ssh_step
    from elphdynamics_tpu_torch.dynamics.hmc import HMCState, draw, make_hmc_step
    from elphdynamics_tpu_torch.dynamics.solve import SolverConfig, resolve_precond, solve_minv
    from elphdynamics_tpu_torch.ops import kpm
    from elphdynamics_tpu_torch.utils.dtypes import trace_noise

    forced = dict(dense_threshold=0, pallas_threshold=0)
    c128 = torch.complex128
    shared = {}

    def probes(dev):
        b = build_bench_step(4, 1.0, 0.1, 0.05, 4, dev, torch.float64, twist=TWIST, **forced)
        if dev == "cpu":
            g = torch.Generator().manual_seed(6)
            shared["probes"] = (0.3 * torch.randn((4, 16, 10), generator=g, dtype=torch.float64),
                                trace_noise((4, 4, 16, 10), c128, "cpu", g))
        x, R = (t.to(dev) for t in shared["probes"])
        pa = resolve_precond(kpm.make_precond(b.ops, b.kpm_cfg), b.params, x)
        res = solve_minv(b.ops, b.params, b.ops.stack(b.ops.derived(b.params, x)), R,
                         SolverConfig(tol=1e-10, maxiter=500, block=True), pa, block=True)
        return res.x, res.iters, res.flag

    def update(model, builder, kw):
        def run(dev):
            b = builder(4, 1.0, 0.1, 0.05, 4, dev, torch.float64, trajectory_time=0.2,
                        twist=TWIST, **kw)
            if dev == "cpu":
                shared[model] = (b.state.x, draw(b.ops, 4, torch.float64, "cpu",
                                                 torch.Generator().manual_seed(1), fdtype=c128))
            x0, draws = shared[model]
            step = make_hmc_step(b.ops, b.mass, replace(b.hmc_cfg, block=True),
                                 kpm.make_symmetric_precond(b.ops, b.kpm_cfg))
            moved = replace(draws, momentum=draws.momentum.to(dev),
                            pseudofermion=draws.pseudofermion.to(dev),
                            uniform=draws.uniform.to(dev))
            st, stats = step(b.params, HMCState(x=x0.to(dev), v=torch.zeros_like(x0, device=dev)),
                             draws=moved)
            return st.x, stats.iters, stats.accepted
        return run

    phase = "small_twisted_reference"
    with _without_dense_abar():
        _card_vs_cpu("holstein_block_probes", probes, ("fold/shared/complex",), relative=True,
                     phase=phase)
        _card_vs_cpu("holstein_block_hmc", update("holstein", build_bench_step, forced),
                     ("fold/shared/complex",), phase=phase)
        _card_vs_cpu("ssh_block_hmc", update("ssh", build_ssh_step, {}),
                     ("fold/column/complex", "fold/chain/complex"), phase=phase)


# block CG against CG at full width: both solutions have normal-equation
# residuals within the checked solve's tol = 1e-5; they may differ by the
# error such a residual allows on a κ ≲ 100 operator
BLOCK_VS_CG_GATE = 1e-3


def phase_driver_twisted() -> dict:
    """``examples/holstein_hmc_twisted.toml`` and ``examples/
    ssh_hmc_twisted.toml`` through the driver on the card, as shipped (4×4,
    1 chain) with their counts cut to one sampling update, its measurement
    and one bin; the update and the measurement replay CUDA graphs."""
    here = os.path.dirname(os.path.abspath(__file__))
    out = {}
    with tempfile.TemporaryDirectory() as work:
        for example, extra in (("holstein_hmc_twisted", ()),
                               ("ssh_hmc_twisted", ("CurrentCurrent_position",))):
            with open(os.path.join(here, "examples", f"{example}.toml"), "rb") as f:
                cfg = tomllib.load(f)
            cfg["hmc"].update(burnin_updates=0, simulation_updates=1, meas_freq=1)
            cfg["simulation"]["num_bins"] = 1
            run = out[example] = run_driver(example, cfg, 1, work, extra_files=extra)
            # the files configure no moves; the update and the measurement
            # replay their graphs under complex hopping
            if any(run["graph_replays_by_part"][p] <= 0 for p in ("update", "measurement")):
                raise RuntimeError(f"the {example} driver run replayed no CUDA graph of a "
                                   f"part: {run['graph_replays_by_part']}")
    return out


# ---------------------------------------------------------------------------
# the deep-β samplers and solver aids: 2MN, dynamic dt, parallel tempering,
# slow-mode deflation, the near-null preconditioner
# ---------------------------------------------------------------------------

def _card_vs_cpu(run: str, fn, modes, tol: float = 1e-12, relative: bool = False,
                 phase: str = "small_deep_reference") -> None:
    """``fn(dev) -> (x, iterations, decisions)`` on the CPU (first: it may
    draw the shared inputs there) and on the card, each with the kernels'
    counts set to 0 before; x within ``tol`` (absolute, or relative to the
    CPU's largest entry), equal iterations and decisions, every table form of
    ``modes`` launched on the card and no kernel on the CPU; one line of
    ``phase``."""
    from elphdynamics_tpu_torch.ops import ckb_cuda

    runs = {}
    for dev in ("cpu", "cuda"):
        ckb_cuda.reset_counts()
        x, iters, dec = fn(dev)
        runs[dev] = (x.cpu(), iters.cpu(), dec.cpu(), dict(ckb_cuda.table_launches))
    (xc, ic, dc, nc), (xg, ig, dg, ng) = runs["cpu"], runs["cuda"]
    dx = (xg - xc).abs().max().item() / (xc.abs().max().item() if relative else 1.0)
    ok = (dx <= tol and torch.equal(ig, ic) and torch.equal(dg, dc)
          and all(ng[m] > 0 for m in modes) and sum(nc.values()) == 0)
    say(phase, run=run, **{"max_rel_dx" if relative else "max_abs_dx": f"{dx:.3e}"},
        tol=tol, iters=ig.flatten().tolist()[:8], iters_equal=bool(torch.equal(ig, ic)),
        decisions_equal=bool(torch.equal(dg, dc)), cuda_launches={m: ng[m] for m in modes},
        cpu_launches=sum(nc.values()))
    if not ok:
        raise RuntimeError(f"{run}: the card disagrees with the CPU reference")


def phase_small_deep_reference() -> None:
    """4×4 float64 runs on the card (K1 forced on, the dense Ā off, so K2
    runs) against the CPU with the same inputs and draws: a 2MN update; a
    dynamic-dt update (dt = 0.04 handed to a step built for dt = 0.05); a
    tempering exchange of 2 rungs × 2 lanes (λ, or α, per chain), Holstein
    and SSH; a deflated and a near-null solve (β = 1.6, the deflation basis
    refreshed 4 times first). x within 1e-12 (updates, exchanges: absolute;
    solves: relative), equal iterations and accept / swap decisions."""
    from elphdynamics_tpu_torch.bench import (
        DEEP_BETA_64X64, build_bench_step, build_deep_beta_solves, build_ssh_step)
    from elphdynamics_tpu_torch.dynamics.hmc import HMCConfig, HMCState, draw, make_hmc_step
    from elphdynamics_tpu_torch.dynamics.tempering import ExchangeDraws
    from elphdynamics_tpu_torch.ops import deflation, kpm
    from elphdynamics_tpu_torch.ops.fourier_accel import build_mass
    from elphdynamics_tpu_torch.ops.nearnull import NearNullConfig
    from elphdynamics_tpu_torch.utils.dtypes import pseudofermion_noise

    f64 = torch.float64
    forced = dict(dense_threshold=0, pallas_threshold=0)
    shared = {}

    def update(integrator: str, dt=None):
        def fn(dev):
            b = build_bench_step(4, 1.0, 0.1, 0.05, 4, dev, f64, trajectory_time=0.2,
                                 integrator=integrator, **forced)
            if dev == "cpu":
                shared["draws"] = draw(b.ops, 4, f64, "cpu", torch.Generator().manual_seed(1))
                shared["x0"] = b.state.x
            d, x0 = shared["draws"], shared["x0"].to(dev)
            moved = replace(d, momentum=d.momentum.to(dev), pseudofermion=d.pseudofermion.to(dev),
                            uniform=d.uniform.to(dev))
            step, args = b.step, ()
            if dt is not None:
                mass = build_mass(b.params.omega.double().cpu().numpy(), b.ops.dtau, b.ops.Ltau,
                                  [dict(omega_min=0.0, omega_max=10.0, mass=0.5)])
                cfg = HMCConfig(dt=0.05, trajectory_time=0.2, Nb=4, tol=1e-5, maxiter=500,
                                construct_guess=True, guess_order=3, integrator=integrator)
                step = make_hmc_step(b.ops, mass, cfg,
                                     kpm.make_precond(b.ops, kpm.KPMConfig(max_order=4)),
                                     dynamic_dt=True)
                args = (torch.tensor(dt, dtype=f64, device=dev),)
            st, stats = step(b.params, HMCState(x=x0, v=torch.zeros_like(x0)), *args, draws=moved)
            return st.x, stats.iters, stats.accepted
        return fn

    def exchange(builder, kw):
        def fn(dev):
            b = builder(4, 1.0, 0.1, 0.05, 4, dev, f64, ladder=(1.0, 0.9), **kw)
            if dev == "cpu":
                g = torch.Generator().manual_seed(2)
                x = b.state.x + 0.3 * torch.randn(b.state.x.shape, generator=g, dtype=f64)
                shared["xv"] = (b.ops.tie(x), b.ops.tie(torch.randn(x.shape, generator=g,
                                                                     dtype=f64)))
                shared["ex"] = ExchangeDraws(
                    pseudofermion=pseudofermion_noise((4, b.ops.Nsites, b.ops.Ltau), f64, "cpu", g),
                    uniform=torch.rand(4, generator=g, dtype=f64))
            x, v = (t.to(dev) for t in shared["xv"])
            d = shared["ex"]
            x1, _, rate, iters, _ = b.exchange(b.params, x, v, 0, draws=ExchangeDraws(
                pseudofermion=d.pseudofermion.to(dev), uniform=d.uniform.to(dev)))
            return x1, iters.reshape(1), rate.reshape(1)
        return fn

    small = replace(DEEP_BETA_64X64, L=4, beta=1.6, n_chains=2,
                    deflation=deflation.DeflationConfig(k=8), nearnull=NearNullConfig(k=4))

    def solve(kind):
        def fn(dev):
            res = build_deep_beta_solves(small, dev, f64, **forced).prepare(kind)()
            return res.x, res.iters, res.flag
        return fn

    holstein = ("fold/shared", "fused/shared")
    with _without_dense_abar():
        _card_vs_cpu("hmc_2mn", update("2mn"), holstein)
        _card_vs_cpu("hmc_dynamic_dt", update("leapfrog", dt=0.04), holstein)
        _card_vs_cpu("exchange_holstein", exchange(build_bench_step, forced), holstein)
        _card_vs_cpu("exchange_ssh", exchange(build_ssh_step, {}),
                     ("fold/column", "fold/chain", "fused/chain"))
        _card_vs_cpu("solve_deflation", solve("deflation"), holstein, relative=True)
        _card_vs_cpu("solve_nearnull", solve("nearnull"), holstein, relative=True)


def phase_deep_beta_kernels() -> dict:
    """Both kernels at the deep-β shapes of ``bench.DEEP_BETA_64X64`` (K =
    Lτ = 160, float32, forward, against the twin): K1 on the fermion
    operator's [8, 4096, 160] (4 chains × 2 spins) and the deflation
    filter's [128, 4096, 160] (4 chains × k = 32); K2 with per-chain
    diagonals and prev on [4, 2, 4096, 160] and [4, 32, 4096, 160]
    (:func:`_kernel_shapes`)."""
    return _kernel_shapes((("fold", (8,)), ("fold", (128,)), ("fused", (4, 2)),
                           ("fused", (4, 32))), 160, "deep_kernel")


def _kernel_shapes(cases, K: int, tag: str) -> dict:
    """Both kernels on the 64×64 Holstein model's tables at the field shapes
    ``cases`` ((kernel, leading axes), each [*lead, 4096, K], float32,
    forward) against the twin: device ms, plain ms, bound (each input read
    once, the output written once) and the dense-matmul library form. K2
    takes per-chain diagonals and prev and adds into the Chebyshev sum (the
    KPM recurrence's step), the chain axis leading; both its outputs are
    checked."""
    from elphdynamics_tpu_torch.ops import checkerboard as ckb
    from elphdynamics_tpu_torch.ops import ckb_cuda

    spec, params = _spec_64()
    sc, G, N = spec.ckb, spec.ckb.ngroups, spec.Nsites
    c, s = params.cosht.float(), params.sinht.float()
    g = torch.Generator(device="cuda").manual_seed(13)
    out = {}
    for kernel, lead in cases:
        v = torch.randn(lead + (N, K), generator=g, device="cuda")
        acc0 = None
        if kernel == "fold":
            kw, fast, plain_fn = {}, ckb_cuda.fold, ckb.fold
            nbytes, flops = 2 * v.numel() * 4 + 2 * c.numel() * 4, 3 * G * v.numel()
        else:
            C = lead[0]
            acc0, sum_kw = _k2_operands(v, g)
            kw = dict(pre=0.5 + torch.rand((C, N), generator=g, device="cuda"),
                      a=0.5 + torch.rand(C, generator=g, device="cuda"),
                      b=torch.rand(C, generator=g, device="cuda") - 0.5, c=-1.0,
                      prev=torch.randn_like(v), **sum_kw)
            fast, plain_fn = ckb_cuda.fold_fused, ckb.fold_fused
            nbytes = 5 * v.numel() * 4 + (2 * c.numel() + C * N + 2 * C + C * K) * 4
            flops = (3 * G + 10) * v.numel()
        rel, err = _errors(_outputs(fast, sc, c, s, v, kw, acc0),
                           _outputs(plain_fn, sc, c, s, v, kw, acc0))
        timed = kw if acc0 is None else kw | dict(acc=acc0)
        ms = device_ms(lambda: fast(sc, c, s, v, **timed), reps=10)
        plain = device_ms(lambda: plain_fn(sc, c, s, v, **timed), reps=3)
        lib = library_ms(sc, c, s, v)
        b_ms, b_by = bound(nbytes, flops)
        shape = "x".join(map(str, v.shape))
        out[f"{kernel}/{shape}"] = dict(ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                                        library_ms=lib, max_abs_err=err)
        say(tag, kernel=kernel, shape=shape, dtype="float32",
            max_rel_err=f"{rel:.3e}", tol=F32_TOL, kernel_ms=f"{ms:.4f}", plain_ms=f"{plain:.4f}",
            bound_ms=f"{b_ms:.4f}", bound_by=b_by, bound_share=f"{b_ms / ms:.3f}",
            library_ms=f"{lib:.4f}")
        if not rel <= F32_TOL:
            raise RuntimeError(f"{kernel} at {shape} disagrees with its twin: {rel}")
    return out


def phase_driver_deep() -> dict:
    """``examples/holstein_hmc_deep_beta.toml`` as shipped (8×8, β = 16, 20
    probes, time-dependent correlations, ``tune_dt`` toward 0.85), cut in
    depth only: 4 tuned burn-in updates, 1 sampling update, 1 bin, 1
    chain (host-bound: thousands of CG iterations per update); and the
    stock 4×4 Holstein example with ``[tempering] ladder = [1.0, 0.9, 0.8,
    0.7]`` (an exchange every update) on 8 chains, 2 sampling updates."""
    here = os.path.dirname(os.path.abspath(__file__))
    out = {}
    with tempfile.TemporaryDirectory() as work:
        with open(os.path.join(here, "examples", "holstein_hmc_deep_beta.toml"), "rb") as f:
            deep = tomllib.load(f)
        deep["hmc"].update(burnin_updates=4, simulation_updates=1)
        deep["simulation"]["num_bins"] = 1
        # dual averaging starts from its shrinkage point log(10·dt₀): its
        # first burn-in steps try dt up to ~13·dt₀, where a β = 16
        # trajectory can run away; such an update is flagged, rejected and
        # fed to the tuner as acceptance 0, as in the JAX package
        out["deep"] = run_driver("holstein_deep_beta_8x8", deep, 1, work,
                                 failures_ok=deep["hmc"]["burnin_updates"])
        with open(os.path.join(here, "examples", "holstein_hmc_square.toml"), "rb") as f:
            temp = tomllib.load(f)
        temp["hmc"].update(burnin_updates=0, simulation_updates=2, trajectory_time=0.2)
        temp["simulation"]["num_bins"] = 2
        temp["tempering"] = {"ladder": [1.0, 0.9, 0.8, 0.7], "freq": 1}
        out["tempering"] = run_driver("holstein_tempering_4x4", temp, 8, work)
    if "tuned_dt" not in out["deep"] or "tempering_acceptance_rate" not in out["tempering"]:
        raise RuntimeError("the deep-beta driver froze no dt, or the tempering driver "
                           "reported no exchange rate")
    return out


# ---------------------------------------------------------------------------
# several ranks: chain sharding, site sharding, NCCL
# ---------------------------------------------------------------------------

RANK_TIMEOUT_S = 600


def _launch(fn, world: int, backend: str, args=()) -> list:
    """``fn(device, *args)`` on ``world`` spawned ranks: gloo ranks share
    card 0 (their messages staged through host memory), NCCL ranks take
    one card each."""
    from elphdynamics_tpu_torch.parallel.multihost import launch

    return launch(fn, world, backend, "cuda:0", args, timeout_s=RANK_TIMEOUT_S)


def _chain_block(device, world: int, rank: int, warmup: int, timed: int) -> dict:
    """``KERNEL_64X64`` on block ``rank`` of ``world`` blocks of its 16
    chains (the whole batch's draws cut to the block), kernel counts set to
    0 just before the updates and read just after."""
    from elphdynamics_tpu_torch.bench import KERNEL_64X64, build
    from elphdynamics_tpu_torch.ops import ckb_cuda
    from elphdynamics_tpu_torch.parallel.chains import ChainBlock

    b = build(KERNEL_64X64, device, torch.float32)
    cb = ChainBlock.of(KERNEL_64X64.n_chains, world, rank)
    state, run = cb.local(b.state), cb.wrap(b.step)
    ckb_cuda.reset_counts()
    acc = []
    for n in range(warmup + timed):
        if n == warmup:
            torch.cuda.synchronize(device)
            t0 = time.perf_counter()
        state, stats = run(b.params, state, generator=b.generator)
        acc.append(stats.accepted)
    torch.cuda.synchronize(device)
    return dict(seconds=time.perf_counter() - t0, chains=cb.n, x=state.x,
                accepted=torch.stack(acc), launches=ckb_cuda.launches,
                fused_launches=ckb_cuda.fused_launches,
                table_launches=dict(ckb_cuda.table_launches),
                launch_shapes=set(ckb_cuda.launch_shapes))


def _rank_chain_64(device, warmup: int, timed: int) -> dict:
    """This rank's :func:`_chain_block`; rank 0 returns every chain's final
    x and decisions."""
    from elphdynamics_tpu_torch.parallel import multihost
    from elphdynamics_tpu_torch.parallel.multihost import all_gather

    out = _chain_block(device, multihost.world(), multihost.rank(), warmup, timed)
    x, acc = all_gather(out["x"]).cpu(), all_gather(out["accepted"], dim=1).cpu()
    primary = multihost.rank() == 0
    return dict(out, x=x if primary else None, accepted=acc if primary else None)


def _rank_driver(device, path: str, run_id: int, n_chains: int, n_devices: int,
                 site_devices: int, dtype=torch.float32) -> dict:
    """One rank of ``simulation.simulate``: its statistics, the processed
    bins it wrote (rank 0) and the final checkpointed x."""
    from elphdynamics_tpu_torch import simulation

    bins, write_bin = [], simulation.out_io.write_bin

    def recording_write_bin(datafolder, processed, bin_index, ops):
        bins.append(processed)
        return write_bin(datafolder, processed, bin_index, ops)

    simulation.out_io.write_bin = recording_write_bin
    try:
        stats = simulation.simulate(path, run_id=run_id, n_chains=n_chains, device=device,
                                    dtype=dtype, n_devices=n_devices, site_devices=site_devices)
    finally:
        simulation.out_io.write_bin = write_bin
    return dict(stats=stats, bins=bins)


def _bin_leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _bin_leaves(v, f"{path}/{k}")
    else:
        yield path, np.asarray(tree)


def _bins_diff(a: list, b: list) -> tuple[float, int]:
    """The largest |difference| of two runs' processed bins, and how many
    arrays were compared."""
    if len(a) != len(b) or not a:
        raise RuntimeError(f"bins: {len(a)} against {len(b)}")
    worst, n = 0.0, 0
    for ba, bb in zip(a, b):
        other = dict(_bin_leaves(bb))
        for path, arr in _bin_leaves(ba):
            worst = max(worst, float(np.abs(other[path] - arr).max()) if arr.size else 0.0)
            n += 1
    return worst, n


def _checkpoint_x(folder: str) -> np.ndarray:
    with np.load(os.path.join(folder, "checkpoint.npz")) as z:
        return z["x"]


def phase_chain_sharded(reference: dict, backend: str = "gloo") -> dict:
    """(a) Chain sharding: 2 ranks run ``KERNEL_64X64`` (16 chains, 8 per
    rank; 1 warm-up and 2 timed updates), each launching K1 and K2; every
    chain's x against the one-rank run of the same configuration
    (``reference``, phase 9). Then the driver on the stock Holstein example
    (cut in depth, 4 chains, float64) on 2 chain ranks against one rank:
    bins and x to 1e-9."""
    t0 = time.perf_counter()
    ranks = _launch(_rank_chain_64, 2, backend, (1, 2))
    x = ranks[0]["x"]
    # the ranks' work block after block in this process: the same draws,
    # the same shapes
    blocks = [_chain_block(torch.device("cuda"), 2, r, 1, 2) for r in range(2)]
    exact = bool(torch.equal(x, torch.cat([blk["x"].cpu() for blk in blocks])))
    dx = float((x - reference["x"]).abs().max())
    acc_equal = bool(torch.equal(ranks[0]["accepted"][-2:].reshape(-1).bool(),
                                 reference["accepted"].reshape(-1).bool()))
    tables = {k: sum(r["table_launches"][k] for r in ranks) for k in ranks[0]["table_launches"]}
    seconds = max(r["seconds"] for r in ranks)
    say(f"chain_sharded_64x64_{backend}", ranks=2, chains_per_rank=ranks[0]["chains"],
        timed_updates=2, sweeps_per_s=f"{16 * 2 / seconds:.6g}",
        one_rank_sweeps_per_s=f"{reference['sweeps_per_s']:.6g}",
        bitwise_vs_blocks_in_one_process=exact, max_abs_dx_vs_16_chain_batch=f"{dx:.3e}",
        accept_equal=acc_equal,
        k1_launches_by_rank=[r["launches"] for r in ranks],
        k2_launches_by_rank=[r["fused_launches"] for r in ranks],
        seconds=f"{time.perf_counter() - t0:.1f}")
    if min(min(r["launches"], r["fused_launches"]) for r in ranks) <= 0:
        raise RuntimeError("a chain rank launched K1 or K2 no time")
    # each rank's work equals the same block's in one process bit for bit;
    # against one 16-chain batch, torch's float32 sums over 8 chains add in
    # another order, so x differs at rounding level amplified along the
    # trajectories, with the same decisions
    if not (exact and acc_equal):
        raise RuntimeError(f"chain-sharded KERNEL_64X64: bitwise against its blocks {exact}, "
                           f"decisions equal to one rank {acc_equal} (max |dx| {dx})")
    out = dict(table_launches=tables, launch_shapes=set().union(*(r["launch_shapes"]
                                                                  for r in ranks)))
    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, "examples", "holstein_hmc_square.toml"), "rb") as f:
        cfg = tomllib.load(f)
    cfg["hmc"].update(burnin_updates=0, simulation_updates=2, trajectory_time=0.2)
    cfg["simulation"].update(num_bins=2, random_seed=17)
    from elphdynamics_tpu_torch.io.output import dump_toml

    with tempfile.TemporaryDirectory() as work:
        cfg["simulation"]["filepath"] = work
        path = os.path.join(work, "square.toml")
        with open(path, "w") as f:
            f.write(dump_toml(cfg))
        t0 = time.perf_counter()
        one = _rank_driver(torch.device("cuda"), path, 1, 4, 1, 1, torch.float64)
        t1 = time.perf_counter()
        two = _launch(_rank_driver, 2, backend, (path, 2, 4, 2, 1, torch.float64))
        t2 = time.perf_counter()
        folder = os.path.join(work, cfg["simulation"]["foldername"])
        dx = float(np.abs(_checkpoint_x(f"{folder}-2") - _checkpoint_x(f"{folder}-1")).max())
    dbin, nbin = _bins_diff(one["bins"], two[0]["bins"])
    say(f"chain_sharded_driver_{backend}", chains=4, ranks=2,
        max_abs_dx=f"{dx:.3e}", max_abs_dbin=f"{dbin:.3e}", arrays=nbin,
        bitwise=dx == 0.0 and dbin == 0.0, one_rank_s=f"{t1 - t0:.1f}",
        two_rank_s=f"{t2 - t1:.1f}")
    # float64: sums over 2 chains instead of 4 may add in another order
    if not (dx <= 1e-9 and dbin <= 1e-9):
        raise RuntimeError(f"the chain-sharded driver differs from one rank: x {dx}, bins {dbin}")
    return out


def _rank_site_small(device, model: str = "holstein") -> dict:
    """(b) / (e) 4×4 float64 on this rank's block of sites against the
    unsharded card run (every rank runs it too), every sampler from equal
    generators: an HMC update with KPM and warm starts, a twisted update,
    a twisted update with ``[solver] block`` (Hermitian block CG at s = 1)
    and the block-CG probe solves of a twisted Green's-function sample (tol
    1e-10), reflection and swap moves, a Runge-Kutta Langevin step, a
    Green's-function sample, of the Holstein or the SSH model. Per run: the
    largest |Δ|, whether decisions and iterations agree, and the sharded
    phonon field (SSH's bond field is whole on every rank)."""
    from elphdynamics_tpu_torch.bench import build_bench_step, build_ssh_step, shard_bench_step
    from elphdynamics_tpu_torch.dynamics.langevin import make_langevin_step
    from elphdynamics_tpu_torch.dynamics.solve import SolverConfig
    from elphdynamics_tpu_torch.dynamics.special_updates import (
        SpecialUpdateConfig, make_reflection_update, make_swap_update)
    from elphdynamics_tpu_torch.measure.greens import sample_greens
    from elphdynamics_tpu_torch.ops import kpm
    from elphdynamics_tpu_torch.ops.fourier_accel import build_Q
    from elphdynamics_tpu_torch.parallel import multihost
    from elphdynamics_tpu_torch.parallel.lattice_shard import SiteShard

    out = {}
    ssh = model == "ssh"
    make = build_ssh_step if ssh else build_bench_step

    def gens():
        return (torch.Generator(device=device).manual_seed(9),
                torch.Generator(device=device).manual_seed(9))

    for name, twist, block in (("hmc", None, False), ("hmc_twisted", (0.3, 0.1), False),
                               ("hmc_twisted_block", (0.3, 0.1), True)):
        b = make(4, 1.0, 0.1, 0.05, 2, device, torch.float64, trajectory_time=0.2, twist=twist)
        if block:
            b = shard_bench_step(replace(b, hmc_cfg=replace(b.hmc_cfg, block=True)))
        shard = SiteShard(b.ops.spec.ckb, getattr(b.ops.spec, "wij_table", None),
                          multihost.world(), multihost.rank())
        lb = shard_bench_step(b, shard)

        def mine(t):
            """This rank's part of a whole phonon field."""
            return t if ssh else shard.local(t)

        g1, g2 = gens()
        s1, st1 = b.step(b.params, b.state, g1)
        s2, st2 = lb.step(lb.params, lb.state, g2)
        out[name] = (float((mine(s1.x) - s2.x).abs().max()),
                     bool(torch.equal(st1.accepted, st2.accepted)),
                     bool(torch.equal(st1.iters, st2.iters)), s2.x.cpu())
        if block:
            bcfg = SolverConfig(tol=1e-10, maxiter=500, block=True)
            g1, g2 = gens()
            gd1 = sample_greens(b.ops, b.params, s1.x, 4, bcfg,
                                kpm.make_precond(b.ops, b.kpm_cfg), g1)
            gd2 = sample_greens(lb.ops, lb.params, mine(s1.x), 4, bcfg,
                                kpm.make_precond(lb.ops, b.kpm_cfg), g2)
            out["greens_twisted_block"] = (
                float((gd1.MinvR - shard.gather(gd2.MinvR)).abs().max()), True,
                bool(torch.equal(gd1.iters, gd2.iters) and int(gd2.flag.max()) == 0), None)
        if twist is not None:
            continue
        ops, lops, params, lp = b.ops, lb.ops, b.params, lb.params
        x, lx = s1.x, mine(s1.x)
        pre, lpre = kpm.make_precond(ops, b.kpm_cfg), kpm.make_precond(lops, b.kpm_cfg)
        ucfg = SpecialUpdateConfig(n_moves=3, tol=1e-5, maxiter=500)
        for uname, upd in (("reflection", make_reflection_update), ("swap", make_swap_update)):
            g1, g2 = gens()
            x1, r1 = upd(ops, ucfg, pre)(params, x, g1)
            x2, r2 = upd(lops, ucfg, lpre)(lp, lx, g2)
            out[uname] = (float((mine(x1) - x2).abs().max()), bool(torch.equal(r1, r2)), True,
                          x2.cpu())
        Q = build_Q(params.omega.double().cpu().numpy(), ops.dtau, ops.Ltau,
                    [dict(omega_min=0.0, omega_max=10.0, mass=0.5)])
        scfg = SolverConfig(tol=1e-8, maxiter=500)
        g1, g2 = gens()
        x1, l1 = make_langevin_step(ops, Q, 1e-3, "rk", scfg, pre)(params, x, g1)
        x2, l2 = make_langevin_step(lops, Q, 1e-3, "rk", scfg, lpre)(lp, lx, g2)
        out["langevin_rk"] = (float((mine(x1) - x2).abs().max()), True,
                              bool(torch.equal(l1.iters, l2.iters)), x2.cpu())
        g1, g2 = gens()
        gd1 = sample_greens(ops, params, x, 4, scfg, pre, g1)
        gd2 = sample_greens(lops, lp, lx, 4, scfg, lpre, g2)
        out["greens"] = (float((gd1.MinvR - shard.gather(gd2.MinvR)).abs().max()), True,
                         bool(torch.equal(gd1.iters, gd2.iters)), None)
    return out


def _say_site_small(ranks: list, model: str, backend: str) -> list:
    """(b) / (e) lines from each rank's :func:`_rank_site_small`: x to
    1e-12 (probe solutions to 1e-10), equal decisions and iterations; SSH's
    bond field bitwise equal on both ranks after each sampler. Returns the
    runs that failed."""
    tag = "" if model == "holstein" else f"{model}_"
    bad = []
    for name in ranks[0]:
        dx = max(r[name][0] for r in ranks)
        same = all(r[name][1] and r[name][2] for r in ranks)
        tol = 1e-10 if name == "greens" else 1e-12
        kv = {}
        if model == "ssh" and ranks[0][name][3] is not None:
            kv["bond_field_bitwise_equal_on_ranks"] = all(
                torch.equal(r[name][3], ranks[0][name][3]) for r in ranks)
            same = same and kv["bond_field_bitwise_equal_on_ranks"]
        say(f"site_small_{tag}{name}_{backend}", ranks=len(ranks), max_abs_dx=f"{dx:.3e}",
            tol=tol, decisions_and_iterations_equal=same, **kv)
        if not (dx <= tol and same):
            bad.append(f"site_small_{tag}{name}")
    return bad


# the 64×64 runs on several ranks take a few leapfrog steps: the counters per
# fold and per force evaluation do not depend on the trajectory's length
SHORT_TRAJECTORY = 0.1
LADDER4 = (1.0, 0.9, 0.8, 0.7)


def _layout(n_chain: int, n_site: int, n_chains: int, spec):
    """This rank's (ChainBlock or None, SiteShard or None) of the 2-D
    layout."""
    from elphdynamics_tpu_torch.parallel import multihost
    from elphdynamics_tpu_torch.parallel.chains import ChainBlock
    from elphdynamics_tpu_torch.parallel.lattice_shard import SiteShard

    site_group, chain_group = multihost.layout_groups(n_chain, n_site)
    block, d = divmod(multihost.rank(), n_site)
    cb = ChainBlock.of(n_chains, n_chain, block, chain_group) if n_chain > 1 else None
    shard = (SiteShard(spec.ckb, getattr(spec, "wij_table", None), n_site, d,
                       site_group, base=block * n_site) if n_site > 1 else None)
    return cb, shard


def _sharded_64(device, cfg_name: str, n_chain: int, n_site: int, measure: bool = False):
    """(g) One warm-up and one timed update of the 64×64 configuration
    ``cfg_name`` (float32, trajectory cut to ``SHORT_TRAJECTORY``) on this
    rank's chains and sites of the ``n_chain`` × ``n_site`` layout, with the
    shard's counters from the timed update and a hash of SSH's whole bond
    field; with ``measure`` then the chain block's measurement (Greens, 2
    probes) on its gathered lattice, as the driver's 2-D layout runs it (K1
    and K2 counted from 0 just before it)."""
    from elphdynamics_tpu_torch import bench
    from elphdynamics_tpu_torch.dynamics.solve import SolverConfig
    from elphdynamics_tpu_torch.measure import measurements as M
    from elphdynamics_tpu_torch.ops import ckb_cuda, kpm

    cfg = getattr(bench, cfg_name.upper())
    b = bench.build(cfg, device, torch.float32, trajectory_time=SHORT_TRAJECTORY)
    cb, shard = _layout(n_chain, n_site, cfg.n_chains, b.ops.spec)
    lb = bench.shard_bench_step(b, shard, cb)
    # the warm-up takes the first calls' costs (NCCL's communicators among them)
    state, _ = lb.step(lb.params, lb.state, lb.generator)
    torch.cuda.synchronize(device)
    shard.reset_counts()
    t0 = time.perf_counter()
    state, stats = lb.step(lb.params, state, lb.generator)
    torch.cuda.synchronize(device)
    whole = not b.ops.is_holstein
    out = dict(seconds=time.perf_counter() - t0, iters=stats.iters.cpu().tolist(),
               flags=stats.flag.cpu().tolist(), accepted=stats.accepted.cpu().tolist(),
               finite=bool(torch.isfinite(state.x).all()), nsolves=lb.hmc_cfg.Nt + 2,
               force_evals=lb.hmc_cfg.Nt + 1, folds=shard.folds, halo_msgs=shard.halo_msgs,
               halo_bytes=shard.halo_bytes, allreduces=shard.allreduces,
               force_sums=shard.force_sums, force_bytes=shard.force_bytes,
               block=tuple(state.x.shape), chains=state.x.shape[0], n_site=n_site,
               field_sha256=(hashlib.sha256(state.x.cpu().numpy().tobytes()).hexdigest()
                             if whole else None))
    if measure:
        mspec = M.MeasurementSpec(nv=2, onsite_corr=(("Greens", True),))
        mstep = M.make_measurement_step(b.ops, mspec, SolverConfig(tol=1e-5, maxiter=2000),
                                        kpm.make_precond(b.ops, b.kpm_cfg))
        x = shard.gather(state.x) if b.ops.is_holstein else state.x
        from elphdynamics_tpu_torch.utils.dtypes import trace_noise
        R = trace_noise((cfg.n_chains, mspec.nv, b.ops.Nsites, b.ops.Ltau), x.dtype, x.device,
                        lb.generator)
        ckb_cuda.reset_counts()
        _, mstats, _ = mstep(b.params, x, R=cb.local(R))
        torch.cuda.synchronize(device)
        out.update(measure_flags=mstats["flag"].cpu().tolist(),
                   table_launches=dict(ckb_cuda.table_launches),
                   launch_shapes=set(ckb_cuda.launch_shapes))
    return out


def _say_sharded_64(tag: str, ranks: list, backend: str, one_rank_s: float) -> dict:
    """The line of a :func:`_sharded_64` run beside ``one_rank_s``, the
    seconds of the same update of one site group's chains on one rank;
    fails on a flag, a non-finite field or ranks of one site group that
    disagree on the decisions, the CG iterations or (SSH) the bits of the
    whole bond field."""
    r = ranks[0]
    n_site = r["n_site"]
    groups = [ranks[i:i + n_site] for i in range(0, len(ranks), n_site)]
    agree = all(x[k] == g[0][k] for g in groups for x in g
                for k in ("accepted", "iters", "field_sha256"))
    cg_iters = sum(r["iters"]) / len(r["iters"]) * r["nsolves"]
    seconds = max(x["seconds"] for x in ranks)
    label = ("ranks on one card, halos staged through the host: not a multi-GPU rate"
             if backend == "gloo" else "one card per rank, NCCL")
    kv = {}
    if r["force_sums"]:
        kv.update(force_allreduces_per_force_eval=f"{r['force_sums'] / r['force_evals']:.3g}",
                  force_allreduce_bytes_per_force_eval=f"{r['force_bytes'] / r['force_sums']:.6g}")
    if r["field_sha256"] is not None:
        kv["bond_field_bitwise_equal_in_site_groups"] = agree
    say(f"{tag}_{backend}", ranks=len(ranks), block="x".join(map(str, r["block"])),
        seconds=f"{seconds:.3f}", one_rank_seconds=f"{one_rank_s:.3f}",
        sharded_over_one_rank=f"{seconds / one_rank_s:.3g}",
        site_groups_agree=agree, cg_iters_per_solve=r["iters"],
        flags=r["flags"], accepted=r["accepted"], folds=r["folds"],
        halo_msgs_per_fold=f"{r['halo_msgs'] / max(r['folds'], 1):.3g}",
        halo_bytes_per_fold=f"{r['halo_bytes'] / max(r['folds'], 1):.6g}",
        allreduces=r["allreduces"], allreduces_per_cg_iter=f"{r['allreduces'] / cg_iters:.3g}",
        **kv, label=repr(label))
    if not all(x["finite"] and max(x["flags"]) == 0 for x in ranks):
        raise RuntimeError(f"{tag}: the update flagged or went non-finite")
    if not agree:
        raise RuntimeError(f"{tag}: the ranks of a site group disagree on the update's "
                           "decisions, iterations or bond field")
    return r


# Holstein's TEMPERING_64X64 on chain ranks against one rank: phase 41
TEMPERING_RUNS = ("ssh_tempering_64x64",)


def _tempering_chain_ranks(device, n_chain: int, names=TEMPERING_RUNS) -> dict:
    """(g) A 64×64 SSH ladder (8 chains, 4 rungs × 2 lanes, trajectory
    cut) on this rank's block of ``n_chain`` chain ranks: 4 updates, an
    exchange every 2 (both parities) across the chain ranks. K1 and K2
    counted from 0 just before the run."""
    from elphdynamics_tpu_torch import bench
    from elphdynamics_tpu_torch.ops import ckb_cuda

    makers = {"ssh_tempering_64x64": lambda: bench.build_ssh_step(
        64, 4.0, 0.1, 0.025, 8, device, torch.float32, trajectory_time=SHORT_TRAJECTORY,
        ladder=LADDER4)}
    out = {}
    for name in names:
        b = makers[name]()
        cb, _ = _layout(n_chain, 1, b.state.x.shape[0], b.ops.spec)
        lb = bench.shard_bench_step(b, chains=cb) if cb is not None else b
        ckb_cuda.reset_counts()
        state, acc, rates = lb.state, [], []
        t0 = time.perf_counter()
        for n in range(1, 5):
            state, stats = lb.step(lb.params, state, lb.generator)
            acc.append(stats.accepted)
            if n % lb.exchange_freq == 0:
                x, v, rate, _, flag = lb.exchange(lb.params, state.x, state.v,
                                                  (n // lb.exchange_freq) % 2, lb.generator)
                state = replace(state, x=x, v=v)
                rates.append((float(rate), int(flag)))
        torch.cuda.synchronize(device)
        out[name] = dict(seconds=time.perf_counter() - t0, accepted=torch.stack(acc).cpu(),
                         rates=rates, x=state.x.cpu(),
                         table_launches=dict(ckb_cuda.table_launches),
                         launch_shapes=set(ckb_cuda.launch_shapes))
    return out


def _rank_pair(device, reference: dict) -> dict:
    """(b), (e) and the two-rank parts of (f) and (g) on this rank of 2:
    the Holstein and SSH 4×4 site-sharded samplers, the stock 4×4 SSH example through
    the driver on 2 site ranks, a site-sharded ``SSH_64X64`` update, and
    tempering on 2 chain ranks."""
    from elphdynamics_tpu_torch import bench

    out = dict(holstein_small=_rank_site_small(device, "holstein"),
               ssh_small=_rank_site_small(device, "ssh"))
    out["driver"] = _rank_driver(device, reference["ssh_driver_path"], 2, 1, 1, 2,
                                 torch.float64)
    out["ssh_64"] = _sharded_64(device, bench.SSH_64X64.name, 1, 2)
    out.update(_tempering_chain_ranks(device, 2))
    return out


def _exchange_4x4(device, n_chain: int, n_site: int, model: str) -> dict:
    """A tempering exchange of each parity on 4×4 float64 (4 rungs × 1 lane,
    the couplings per chain) on this rank's part of the layout."""
    from elphdynamics_tpu_torch import bench

    make = bench.build_ssh_step if model == "ssh" else bench.build_bench_step
    b = make(4, 1.0, 0.1, 0.05, 4, device, torch.float64, trajectory_time=0.2, ladder=LADDER4)
    cb, shard = _layout(n_chain, n_site, 4, b.ops.spec)
    lb = bench.shard_bench_step(b, shard, cb) if (cb or shard) else b
    g = torch.Generator(device=device).manual_seed(7)
    x, v, res = lb.state.x + 0.05, lb.state.v, []
    for parity in (0, 1):
        x, v, rate, _, flag = lb.exchange(lb.params, x, v, parity, g)
        res.append((float(rate), int(flag)))
    return dict(rates=res, x=x.cpu())


def _deflated_4x4(device, n_chain: int, n_site: int) -> dict:
    """An HMC update with slow-mode deflation (k = 4, float64 basis) and the
    nᵥ = 4 probe solves of a Green's-function sample by block CG, 4×4
    float64, 4 chains, on this rank's part of the layout."""
    from elphdynamics_tpu_torch import bench
    from elphdynamics_tpu_torch.dynamics.hmc import HMCState, make_hmc_step
    from elphdynamics_tpu_torch.dynamics.solve import SolverConfig
    from elphdynamics_tpu_torch.measure.greens import sample_greens
    from elphdynamics_tpu_torch.models.adapter import make_model_ops
    from elphdynamics_tpu_torch.ops import deflation, kpm
    from elphdynamics_tpu_torch.parallel.lattice_shard import shard_model
    from elphdynamics_tpu_torch.dynamics.tempering import chain_params

    b = bench.build_bench_step(4, 1.0, 0.1, 0.05, 4, device, torch.float64, trajectory_time=0.2)
    cfg = replace(b.hmc_cfg, deflate_k=4, deflate_filter=4, deflate_power=3)
    g0 = torch.Generator(device=device).manual_seed(40)
    defl = deflation.init(4, 4, b.ops.Nsites, b.ops.Ltau, dtype=torch.float64, device=device,
                          generator=g0)
    cb, shard = _layout(n_chain, n_site, 4, b.ops.spec)
    ops, params, x, v = b.ops, b.params, b.state.x + 0.05, b.state.v
    if shard is not None:
        spec, params = shard_model(ops.spec, params, shard)
        ops = make_model_ops(spec)
        x, v, defl = shard.local(x), shard.local(v), deflation.cut(defl, shard.local)
    if cb is not None:
        params = chain_params(params, cb.lo, cb.n)
        x, v, defl = cb.local(x), cb.local(v), cb.local(defl)
    pre = kpm.make_precond(ops, b.kpm_cfg)
    step = make_hmc_step(ops, b.mass, cfg, pre)
    if cb is not None:
        run = cb.wrap(step)
        st, stats = run(params, HMCState(x=x, v=v, defl=defl),
                        generator=torch.Generator(device=device).manual_seed(3))
    else:
        st, stats = step(params, HMCState(x=x, v=v, defl=defl),
                         torch.Generator(device=device).manual_seed(3))
    # the probes of every chain and site, cut to this rank's part
    from elphdynamics_tpu_torch.utils.dtypes import trace_noise

    R = trace_noise((4, 4, b.ops.Nsites, b.ops.Ltau), torch.float64, device,
                    torch.Generator(device=device).manual_seed(5))
    if shard is not None:
        R = shard.local(R)
    if cb is not None:
        R = cb.local(R)
    gd = sample_greens(ops, params, st.x, 4, SolverConfig(tol=1e-10, maxiter=500, block=True),
                       pre, R=R)
    return dict(x=st.x.cpu(), accepted=stats.accepted.cpu(), iters=stats.iters.cpu(),
                flag=stats.flag.cpu(), MinvR=gd.MinvR.cpu(), giters=gd.iters.cpu(),
                gflag=gd.flag.cpu())


def _twisted_block_4x4(device, n_chain: int, n_site: int) -> dict:
    """A twisted 4×4 float64 HMC update of 4 chains with ``[solver] block``
    (the trajectory solves by Hermitian block CG at s = 1) and the nᵥ = 4
    probe solves of a Green's-function sample by block CG (tol 1e-10), on
    this rank's part of the layout."""
    from elphdynamics_tpu_torch import bench
    from elphdynamics_tpu_torch.dynamics.solve import SolverConfig
    from elphdynamics_tpu_torch.measure.greens import sample_greens
    from elphdynamics_tpu_torch.ops import kpm
    from elphdynamics_tpu_torch.utils.dtypes import trace_noise

    b = bench.build_bench_step(4, 1.0, 0.1, 0.05, 4, device, torch.float64,
                               trajectory_time=0.2, twist=(0.3, 0.1))
    b = replace(b, hmc_cfg=replace(b.hmc_cfg, block=True))
    cb, shard = _layout(n_chain, n_site, 4, b.ops.spec)
    lb = bench.shard_bench_step(b, shard, cb)
    st, stats = lb.step(lb.params, lb.state, torch.Generator(device=device).manual_seed(3))
    R = trace_noise((4, 4, b.ops.Nsites, b.ops.Ltau), torch.complex128, device,
                    torch.Generator(device=device).manual_seed(5))
    if shard is not None:
        R = shard.local(R)
    if cb is not None:
        R = cb.local(R)
    gd = sample_greens(lb.ops, lb.params, st.x, 4, SolverConfig(tol=1e-10, maxiter=500, block=True),
                       kpm.make_precond(lb.ops, b.kpm_cfg), R=R)
    return dict(x=st.x.cpu(), accepted=stats.accepted.cpu(), iters=stats.iters.cpu(),
                flag=stats.flag.cpu(), MinvR=gd.MinvR.cpu(), giters=gd.iters.cpu(),
                gflag=gd.flag.cpu())


def _rank_quad(device) -> dict:
    """(f) and the four-rank part of (g) on this rank of 2 chain × 2 site
    ranks: the deflated update and block-CG probe solves, tempering
    exchanges (Holstein and SSH) at 4×4 float64, each also run on one rank
    by rank 0 (no collective); ``KERNEL_64X64`` on the 2×2 layout and the
    chain blocks' measurement."""
    from elphdynamics_tpu_torch import bench

    out = dict(deflated=_deflated_4x4(device, 2, 2),
               twisted_block=_twisted_block_4x4(device, 2, 2),
               exchange_holstein=_exchange_4x4(device, 2, 2, "holstein"),
               exchange_ssh=_exchange_4x4(device, 2, 2, "ssh"))
    out["kernel_64"] = _sharded_64(device, bench.KERNEL_64X64.name, 2, 2, measure=True)
    return out


def _one_rank_4x4(device) -> dict:
    """The one-rank card runs of (f)'s 4×4 pieces (this process)."""
    return dict(deflated=_deflated_4x4(device, 1, 1),
                twisted_block=_twisted_block_4x4(device, 1, 1),
                exchange_holstein=_exchange_4x4(device, 1, 1, "holstein"),
                exchange_ssh=_exchange_4x4(device, 1, 1, "ssh"))


def _blocks(ranks: list, key: str, field: str, n_chain: int, n_site: int, site_axis: bool):
    """The whole tensor from a 2-D layout's ranks' blocks: sites along
    axis −2 within a chain block (when ``site_axis``), chain blocks along
    axis 0."""
    rows = []
    for b in range(n_chain):
        parts = [ranks[b * n_site + s][key][field] for s in range(n_site)]
        rows.append(torch.cat(parts, dim=-2) if site_axis else parts[0])
    return torch.cat(rows, dim=0)


def phase_h2(reference: dict, backend: str = "gloo", quad: bool = True) -> dict:
    """(e)–(g) Slice H2 on gloo ranks sharing card 0 (or NCCL ranks, one card
    each): SSH under site sharding, the 2-D layout, block CG, deflation and
    tempering across ranks against one rank; ``SSH_64X64`` site-sharded,
    ``KERNEL_64X64`` on 2×2 and a 64×64 SSH ladder on 2 chain ranks at full
    width, each beside its one-rank time in ``reference`` (``TEMPERING_64X64``
    on 2 chain ranks: phase 41). Returns each
    kernel-launching run's counts and shapes."""
    from elphdynamics_tpu_torch.io.output import dump_toml

    t0 = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, "examples", "ssh_hmc_square.toml"), "rb") as f:
        cfg = tomllib.load(f)
    # 1 + 2 updates: at 0 + 2 the second measurement's probe solve amplifies
    # K1's rounding against the halo fold's to 7.2e-9 on Nsqr (phase 28 in
    # the module docstring; scripts/ssh_site_parity.py)
    cfg["hmc"].update(burnin_updates=1, simulation_updates=2, trajectory_time=0.05)
    cfg["simulation"].update(num_bins=2, random_seed=17)
    cfg["measurements"]["num_random_vectors"] = 4
    cfg["solver"].setdefault("preconditioner", {})["max_order"] = 8
    paths = {}
    with tempfile.TemporaryDirectory() as work:
        cfg["simulation"]["filepath"] = work
        path = os.path.join(work, "ssh_square.toml")
        with open(path, "w") as f:
            f.write(dump_toml(cfg))
        one = _rank_driver(torch.device("cuda"), path, 1, 1, 1, 1, torch.float64)
        pair = _launch(_rank_pair, 2, backend, (dict(ssh_driver_path=path),))
        folder = os.path.join(work, cfg["simulation"]["foldername"])
        dx = float(np.abs(_checkpoint_x(f"{folder}-2") - _checkpoint_x(f"{folder}-1")).max())
    # (b), (e) Holstein's and SSH's samplers at 4×4 against the unsharded card run
    bad = (_say_site_small([r["holstein_small"] for r in pair], "holstein", backend)
           + _say_site_small([r["ssh_small"] for r in pair], "ssh", backend))
    # (f) the stock SSH example through the driver on 2 site ranks
    dbin, nbin = _bins_diff(one["bins"], pair[0]["driver"]["bins"])
    acc_same = all(r["driver"]["stats"]["acceptance_rate"] == one["stats"]["acceptance_rate"]
                   for r in pair)
    say(f"h2_ssh_driver_site_{backend}", ranks=2, max_abs_dx=f"{dx:.3e}",
        max_abs_dbin=f"{dbin:.3e}", arrays=nbin, tol=1e-9, acceptance_equal=acc_same)
    if not (dx <= 1e-9 and dbin <= 1e-9 and acc_same):
        bad.append("ssh_driver_site")
    # (g) SSH_64X64 on 2 site ranks
    _say_sharded_64("h2_ssh_64x64_site2", [r["ssh_64"] for r in pair], backend,
                    reference["one_rank_s"]["ssh_64x64"])
    # (g) tempering on 2 chain ranks against the one-rank runs
    for name in TEMPERING_RUNS:
        runs = [r[name] for r in pair]
        ref = reference[name]
        acc = torch.cat([r["accepted"] for r in runs], dim=1)[-ref["accepted"].shape[0]:]
        same_acc = bool(torch.equal(acc.bool(), ref["accepted"].bool()))
        same_rates = all(r["rates"] == ref["rates"] for r in runs)
        dxt = float((torch.cat([r["x"] for r in runs]) - ref["x"]).abs().max())
        say(f"h2_{name}_chain2_{backend}", ranks=2, exchanges=len(ref["rates"]),
            exchange_rates=[r for r, _ in runs[0]["rates"]],
            one_rank_exchange_rates=[r for r, _ in ref["rates"]], rates_equal=same_rates,
            accept_equal=same_acc, max_abs_dx_vs_one_rank=f"{dxt:.3e}",
            seconds=f"{max(r['seconds'] for r in runs):.1f}",
            one_rank_seconds=f"{ref['seconds']:.1f}",
            k1_launches_by_rank=[sum(v for k, v in r["table_launches"].items()
                                     if k.startswith("fold/")) for r in runs],
            k2_launches_by_rank=[sum(v for k, v in r["table_launches"].items()
                                     if k.startswith("fused/")) for r in runs])
        if not (same_acc and same_rates):
            bad.append(name)
        for i, r in enumerate(runs):
            paths[f"{name}_chain_rank{i}"] = r
    if quad:
        one4 = _one_rank_4x4(torch.device("cuda"))
        quadr = _launch(_rank_quad, 4, backend)
        # (f) deflation, block-CG probes, the twisted block-CG update and
        # probes, and exchanges on 2×2 against one rank
        for key, label, tol in (("deflated", "deflated_hmc_and_block_cg", 1e-9),
                                ("twisted_block", "twisted_block_cg_hmc_and_probes", 1e-12)):
            x = _blocks(quadr, key, "x", 2, 2, True)
            z = _blocks(quadr, key, "MinvR", 2, 2, True)
            dxd = float((x - one4[key]["x"]).abs().max())
            dz = float((z - one4[key]["MinvR"]).abs().max())
            same = all(torch.equal(_blocks(quadr, key, f, 2, 2, False), one4[key][f])
                       for f in ("accepted", "iters", "giters"))
            same = same and all(int(r[key][f].max()) == 0 for r in quadr for f in ("flag", "gflag"))
            say(f"h2_2x2_{label}_{backend}", ranks=4, max_abs_dx=f"{dxd:.3e}",
                max_abs_dz=f"{dz:.3e}", tol=tol, decisions_and_iterations_equal=same)
            if not (dxd <= tol and dz <= tol and same):
                bad.append(f"{key}_2x2")
        for model in ("holstein", "ssh"):
            key = f"exchange_{model}"
            x = _blocks(quadr, key, "x", 2, 2, model == "holstein")
            dxe = float((x - one4[key]["x"]).abs().max())
            same = all(r[key]["rates"] == one4[key]["rates"] for r in quadr)
            if model == "ssh":
                same = same and all(torch.equal(quadr[2 * b + 1][key]["x"],
                                                quadr[2 * b][key]["x"]) for b in range(2))
            say(f"h2_2x2_{key}_{backend}", ranks=4, rates=[r for r, _ in one4[key]["rates"]],
                rates_equal=same, max_abs_dx=f"{dxe:.3e}", tol=1e-9)
            if not (dxe <= 1e-9 and same):
                bad.append(key)
        # (g) KERNEL_64X64 on 2×2 and the chain blocks' measurement
        _say_sharded_64("h2_kernel_64x64_2x2", [r["kernel_64"] for r in quadr], backend,
                        reference["one_rank_s"]["kernel_64x64"])
        for i, r in enumerate(quadr):
            if max(r["kernel_64"]["measure_flags"]) != 0:
                bad.append("chain_block_measurement")
            paths[f"chain_block_measure_64x64_rank{i}"] = r["kernel_64"]
    say(f"h2_{backend}", seconds=f"{time.perf_counter() - t0:.1f}")
    if bad:
        raise RuntimeError(f"slice H2 runs disagree with one rank or failed: {bad}")
    return paths


def phase_nccl(reference: dict, h2_reference: dict) -> dict | None:
    """(d) (a), (b), (e)–(g) with one rank per card under NCCL, when the
    machine has two cards (the 2×2 layout only with four); there a site
    shard's calls replay CUDA graphs, its collectives inside them. Then
    phase 41's chain ranks and the graphed site shards held to their eager
    forms (:func:`phase_graphed_sites_nccl`)."""
    n = torch.cuda.device_count()
    if n < 2:
        say("nccl", skipped=f"'one CUDA device on this machine ({n}); NCCL ranks need one "
                            "card each'")
        return None
    out = phase_chain_sharded(reference, "nccl")
    paths = phase_h2(h2_reference, "nccl", quad=n >= 4)
    if n < 4:
        say("nccl_2x2", skipped=f"'{n} CUDA devices on this machine; the 2x2 layout needs 4'")
    return dict(chain_sharded=out, h2=paths, graphed_chains=phase_graphed_chains("nccl"),
                graphed_sites=phase_graphed_sites_nccl(n))


def _one_rank_64(cfg) -> float:
    """Seconds of one update of ``cfg`` (float32, trajectory cut to
    ``SHORT_TRAJECTORY``) on one rank after one warm-up update, as
    :func:`_sharded_64` times its ranks."""
    from elphdynamics_tpu_torch import bench

    b = bench.build(cfg, "cuda", torch.float32, trajectory_time=SHORT_TRAJECTORY)
    state, _ = b.step(b.params, b.state, b.generator)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, stats = b.step(b.params, state, b.generator)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    if not (bool(torch.isfinite(state.x).all()) and int(stats.flag.max()) == 0):
        raise RuntimeError(f"one-rank {cfg.name}: the update flagged or went non-finite")
    return seconds


def h2_references() -> dict:
    """The one-rank runs that (g) is held against: the 64×64 SSH ladder of
    :func:`_tempering_chain_ranks` (``TEMPERING_64X64`` on chain ranks is
    held against one rank in phase 41), and the times of one
    ``SSH_64X64`` update and one 8-chain ``KERNEL_64X64`` update (a chain
    block of the 2×2 layout) at the sharded runs' trajectory, run here."""
    from elphdynamics_tpu_torch.bench import KERNEL_64X64, SSH_64X64

    out = _tempering_chain_ranks(torch.device("cuda"), 1, ("ssh_tempering_64x64",))
    r = out["ssh_tempering_64x64"]
    say("ssh_tempering_64x64_one_rank", exchange_rates=[x for x, _ in r["rates"]],
        seconds=f"{r['seconds']:.1f}")
    out["one_rank_s"] = {"ssh_64x64": _one_rank_64(SSH_64X64),
                         "kernel_64x64": _one_rank_64(replace(KERNEL_64X64, n_chains=8))}
    say("h2_one_rank_64x64", trajectory_time=SHORT_TRAJECTORY,
        **{f"{k}_seconds": f"{v:.3f}" for k, v in out["one_rank_s"].items()})
    return out


def nccl_only() -> int:
    """(d) alone, for a machine with several cards: the build, the one-rank
    ``KERNEL_64X64`` run that (a) is held against, then (a), (b), (e)–(g)
    and phase 41's chain ranks on NCCL ranks, one card each (the 2×2 layout
    with four cards). Run as ``python3 -c "import chip_smoke as
    c, sys; sys.exit(c.nccl_only())"``."""
    if torch.cuda.device_count() < 2:
        print("chip_smoke: NCCL ranks need two CUDA devices", file=sys.stderr)
        return 1
    from elphdynamics_tpu_torch.bench import KERNEL_64X64

    phase_card()
    phase_build()
    ref = run_config(KERNEL_64X64, warmup=1, timed=2)
    phase_nccl(ref, h2_references())
    say("total", seconds=f"{time.perf_counter() - T_START:.1f}")
    return 0


# the in-loop operators of loop_precision "high" (three bf16 products) and
# "default" (one), accumulated in float32, relative to max|A|·|y|: bf16
# keeps 8 significant bits, so rounding a factor moves it by ≤ 2⁻⁸ and one
# product is off by ≤ 2⁻⁷ + 2⁻¹⁶ (the gate adds the float32 sum's worst
# case N·2⁻²⁴, 2⁻¹⁴ at N = 1024); hi + lo carries a factor to ≤ 2⁻¹⁶, so
# three products are off by ≤ 3·2⁻¹⁶, and their gate leaves 2⁻¹⁶ for a sum
# that sits far below its worst case
BF16X3_GATE = 2.0 ** -14
BF16X1_GATE = 2.0 ** -7 + 2.0 ** -14


def phase_loop_precision() -> None:
    """32. ``[solver] loop_precision``: on the dense Holstein branch at the
    bench 8×8 (128 chains) and 32×32 (32 chains) shapes, one in-loop
    exp(−Δτ·K) apply and one of its adjoint at "high" (bf16×3 in float32),
    "default" (one bf16 product in float32) and "highest" against float64,
    on a spin-stacked float32 field. Fails when a cheaper operator equals
    the float32 one, when "high" is off by more than ``BF16X3_GATE`` of
    max|A|·|y| or "default" by more than ``BF16X1_GATE``, or when "default"
    is not the less accurate of the two."""
    from elphdynamics_tpu_torch.bench import build_bench_step
    from elphdynamics_tpu_torch.models import holstein as Hm

    gates = {"high": BF16X3_GATE, "default": BF16X1_GATE}
    for name, L, chains in (("bench_8x8", 8, 128), ("dense_32x32", 32, 32)):
        b = build_bench_step(L, 4.0, 0.1, 0.05, chains, "cuda", torch.float32)
        C, N, Lt = b.state.x.shape
        y = torch.randn((C, 2, N, Lt), device="cuda",
                        generator=torch.Generator("cuda").manual_seed(9))
        for form, apply, A in (("expK", Hm.apply_expK, b.params.expK),
                               ("expK_T", Hm.apply_expK_T, b.params.expK.mT)):
            exact = torch.matmul(A.double(), y.double())
            scale = float(torch.matmul(A.double().abs(), y.double().abs()).max())
            full = apply(b.ops.spec, b.params, y, "highest")
            err = {"highest": float((full.double() - exact).abs().max()) / scale}
            cheaper = {}
            for prec in gates:
                out = apply(b.ops.spec, b.params, y, prec)
                err[prec] = float((out.double() - exact).abs().max()) / scale
                cheaper[prec] = out.dtype == torch.float32 and not torch.equal(out, full)
            say(f"loop_precision_{name}", apply=form, N=N, field=list(y.shape),
                dense=b.ops.spec.dense_ckb,
                **{f"{p}_rel_err": f"{e:.3e}" for p, e in err.items()},
                **{f"{p}_gate": f"{g:.3e}" for p, g in gates.items()},
                high_is_bf16x3=cheaper["high"], default_is_bf16=cheaper["default"])
            bad = [p for p, g in gates.items() if not (cheaper[p] and err[p] <= g)]
            if not b.ops.spec.dense_ckb or bad or err["default"] <= err["high"]:
                raise RuntimeError(f"loop_precision {name} {form}: the in-loop operators "
                                   f"{bad or list(gates)} are not the bf16 ones within "
                                   f"their gates (errors {err})")


class _DrawsTaken(Exception):
    """Stops a driver run once its first update has drawn."""


def _first_draws(cfg: dict, seed: int, chains: int) -> dict:
    """The start fields and the first update's draws of the driver on the
    parsed input ``cfg`` at ``seed``, recorded at the draw seams
    (``simulation.init_phonons_half_filled``, ``dynamics.hmc.draw``); the
    run stops there."""
    from elphdynamics_tpu_torch import simulation
    from elphdynamics_tpu_torch.dynamics import hmc

    seen = {}
    init, draw = simulation.init_phonons_half_filled, hmc.draw

    def rec_init(*a, **k):
        seen["x0"] = init(*a, **k)
        return seen["x0"]

    def rec_draw(*a, **k):
        d = draw(*a, **k)
        seen.update(momentum=d.momentum, pseudofermion=d.pseudofermion, uniform=d.uniform)
        raise _DrawsTaken

    cfg = json.loads(json.dumps(cfg))
    simulation.init_phonons_half_filled, hmc.draw = rec_init, rec_draw
    try:
        with tempfile.TemporaryDirectory() as work:
            cfg["simulation"].update(filepath=work, random_seed=seed)
            simulation.simulate(cfg, n_chains=chains, device="cuda", dtype=torch.float32)
    except _DrawsTaken:
        pass
    finally:
        simulation.init_phonons_half_filled, hmc.draw = init, draw
    if len(seen) != 4:
        raise RuntimeError(f"seed {seed}: the first update drew nothing")
    return {k: v.double().cpu() for k, v in seen.items()}


SEEDS = (2, 3, 4)


def phase_seed_draws() -> set:
    """33. Independent draws across seeds with the CUDA generator: the
    driver on ``examples/holstein_hmc_square.toml`` at 64×64, β = 4 (the
    64×64 driver run's model; 4 chains, float32) at seeds 2, 3 and 4,
    stopped once the first update has drawn. Every chain's start field
    x₀, momenta, pseudofermions and Metropolis uniform differ between every
    two seeds (and the chains of a seed from each other); the uniforms are
    printed. Returns the kernels' launch shapes of the runs' set-up."""
    import itertools

    from elphdynamics_tpu_torch.ops import ckb_cuda

    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, "examples", "holstein_hmc_square.toml"), "rb") as f:
        cfg = tomllib.load(f)
    cfg["lattice"]["L"] = 64
    cfg["holstein"]["beta"] = 4.0
    cfg["hmc"].update(dt=0.025, num_multitimesteps=4, burnin_updates=0, simulation_updates=1)
    cfg["simulation"]["num_bins"] = 1
    chains = 4
    ckb_cuda.reset_counts()
    runs = {s: _first_draws(cfg, s, chains) for s in SEEDS}
    shapes = set(ckb_cuda.launch_shapes)
    same = []
    for name in ("x0", "momentum", "pseudofermion", "uniform"):
        for a, b in itertools.combinations(SEEDS, 2):
            same += [(name, a, b, c) for c in range(chains)
                     if torch.equal(runs[a][name][c], runs[b][name][c])]
        for s in SEEDS:
            rows = runs[s][name].reshape(chains, -1)
            same += [(name, s, c1, c2) for c1, c2 in itertools.combinations(range(chains), 2)
                     if torch.equal(rows[c1], rows[c2])]
    say("seed_draws_64x64", chains=chains, seeds=list(SEEDS),
        uniforms={s: [round(float(u), 6) for u in runs[s]["uniform"]] for s in SEEDS},
        x0_first={s: [round(float(x[0, 0]), 6) for x in runs[s]["x0"]] for s in SEEDS},
        equal_pairs=len(same))
    if same:
        raise RuntimeError(f"draws equal across seeds or chains: {same[:8]}")
    return shapes


U32 = 2.0 ** -24


def phase_float32_energy() -> set:
    """35. The HMC energy in float32 against float64 on the same draws: the
    64×64 driver run's model (``examples/holstein_hmc_square.toml`` at
    L = 64, β = 4, dt 0.025, Fourier-acceleration mass 0.1), 4 chains, one
    leapfrog step, start fields and draws made in float64 and cast. H at
    the start holds the same state in both dtypes: each chain within
    u·(|S| + K), u = 2⁻²⁴ (every term rounded once; the kinetic energy
    through float32 mass circulants was off by ~0.064, 4× that); ΔH, two
    evaluations one step apart, within twice that. Returns the kernels'
    launch shapes."""
    from elphdynamics_tpu_torch.dynamics import hmc
    from elphdynamics_tpu_torch.dynamics.hmc import HMCState, make_hmc_step
    from elphdynamics_tpu_torch.dynamics.init_phonons import init_phonons_half_filled
    from elphdynamics_tpu_torch.io.config import build_setup
    from elphdynamics_tpu_torch.ops import ckb_cuda, kpm

    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, "examples", "holstein_hmc_square.toml"), "rb") as f:
        cfg = tomllib.load(f)
    cfg["lattice"]["L"] = 64
    cfg["holstein"]["beta"] = 4.0
    cfg["hmc"].update(dt=0.025, num_multitimesteps=4, trajectory_time=0.025)
    chains, stats = 4, {}
    g = torch.Generator("cuda").manual_seed(5)
    ckb_cuda.reset_counts()
    with tempfile.TemporaryDirectory() as work:
        for dtype in (torch.float64, torch.float32):
            st = build_setup(cfg, work, torch.device("cuda"), dtype)
            if dtype == torch.float64:
                x0 = init_phonons_half_filled(st.ops, st.params, chains, g)
                d64 = hmc.draw(st.ops, chains, torch.float64, "cuda", g)
            step = make_hmc_step(st.ops, st.fa_mass, st.hmc_cfg,
                                 kpm.make_precond(st.ops, st.kpm_cfg))
            draws = replace(d64, momentum=d64.momentum.to(dtype),
                            pseudofermion=d64.pseudofermion.to(dtype))
            x = x0.to(dtype)
            _, stats[dtype] = step(st.params, HMCState(x=x, v=torch.zeros_like(x)), draws=draws)
    shapes = set(ckb_cuda.launch_shapes)
    a, b = stats[torch.float32], stats[torch.float64]
    dH0 = ((a.H - a.delta_H) - (b.H - b.delta_H)).double().cpu()
    ddH = (a.delta_H - b.delta_H).double().cpu()
    bound = (U32 * (b.S.abs() + b.K)).double().cpu()
    ok = (bool((dH0.abs() <= bound).all()) and bool((ddH.abs() <= 2 * bound).all())
          and int(a.flag.max()) == 0 == int(b.flag.max()))
    say("float32_energy_64x64", chains=chains,
        H_start=[f"{float(h):.4f}" for h in (b.H - b.delta_H).cpu()],
        H_start_f32_minus_f64=[f"{float(d):.3e}" for d in dH0],
        bound_per_chain=[f"{float(r):.3e}" for r in bound],
        dH_f32_minus_f64=[f"{float(d):.3e}" for d in ddH], ok=ok)
    if not ok:
        raise RuntimeError("float32 H or ΔH differs from float64 beyond its rounding")
    return shapes


# the float32 single-site anchor on the card (tests/test_accum.py:81): many
# chains, few updates (a single site costs almost nothing; updates are
# host-bound)
ED_CHAINS, ED_BURNIN, ED_MEAS = 4096, 30, 30
ED_DENSITY_TOL, ED_X2_TOL = 0.08, 0.1
# thermalised: the first and second measured halves' ⟨x²⟩ within this many
# standard errors of their difference (from the chains' spread: chains are
# independent, updates of one chain are not)
ED_FLAT_SIGMAS = 4.0


def phase_ed_float32() -> None:
    """34. The float32 single-site anchor on the card: the single-site
    Holstein model (β = 2, Δτ = 0.1, ω = 1, λ = 1, μ = −0.5) in float32
    through the port's HMC (dt 0.05, trajectory 1, Nb 4, tol 1e-5, warm
    starts) and measurements (nᵥ = 10), ``ED_CHAINS`` chains, ``ED_BURNIN``
    burn-in updates and ``ED_MEAS`` measured ones; density and ⟨x²⟩
    against ``single_site_holstein_ed`` within 0.08 and 0.1 (the tolerances
    of ``tests/test_accum.py``), and the ⟨x²⟩ of the first and second
    halves of the measured updates within ``ED_FLAT_SIGMAS`` standard
    errors of each other (the chains have thermalised; the running mean
    over the measured updates is printed). Fails when any of them does not
    hold."""
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(here, "tests"))
    import torch_ed_helpers as E
    from ed_reference import single_site_holstein_ed
    from elphdynamics_tpu_torch.dynamics.hmc import HMCConfig
    from elphdynamics_tpu_torch.measure.measurements import MeasurementSpec

    t0 = time.perf_counter()
    beta, dtau, omega, lam, mu = 2.0, 0.1, 1.0, 1.0, -0.5
    ops, params = E.single_site(beta, dtau, omega, lam, mu, dtype=torch.float32, device="cuda")
    ed = single_site_holstein_ed(beta, omega, lam, mu)
    cfg = HMCConfig(dt=0.05, trajectory_time=1.0, Nb=4, tol=1e-5, maxiter=1000,
                    construct_guess=True)
    hist: list = []
    res, _ = E.run_hmc_with_measurements(ops, params, cfg, MeasurementSpec(nv=10),
                                         n_chains=ED_CHAINS, burnin=ED_BURNIN, nmeas=ED_MEAS,
                                         seed=11, history=hist)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    dens = E.scalar(res, "global", "density")
    x2 = E.scalar(res, "onsite", "x2")
    x2s = torch.stack([h[0] for h in hist])          # [measured, C]
    half = x2s.shape[0] // 2
    d = x2s[:half].mean(dim=0) - x2s[half:].mean(dim=0)
    drift, sigma = float(d.mean()), float(d.std() / math.sqrt(d.numel()))
    means = x2s.mean(dim=1)
    running = [float(means[:k].mean()) for k in range(5, len(means) + 1, 5)]
    ok = (abs(dens - ed["n"]) < ED_DENSITY_TOL and abs(x2 - ed["x2"]) < ED_X2_TOL
          and abs(drift) < ED_FLAT_SIGMAS * sigma)
    say("ed_single_site_float32", chains=ED_CHAINS, burnin=ED_BURNIN, measured=ED_MEAS,
        density=f"{dens:.5f}", density_ed=f"{ed['n']:.5f}", density_tol=ED_DENSITY_TOL,
        x2=f"{x2:.5f}", x2_ed=f"{ed['x2']:.5f}", x2_tol=ED_X2_TOL,
        x2_first_half=f"{float(x2s[:half].mean()):.5f}",
        x2_second_half=f"{float(x2s[half:].mean()):.5f}", halves_diff=f"{drift:.5f}",
        halves_diff_sigma=f"{sigma:.5f}", flat_sigmas=ED_FLAT_SIGMAS,
        x2_running_mean_every_5=[round(r, 5) for r in running],
        acceptance=f"{statistics.mean(h[1] for h in hist):.4f}",
        dtype=str(res["global"]["density"].dtype), seconds=f"{seconds:.1f}", ok=ok)
    if not ok:
        raise RuntimeError("the float32 single-site run left its ED tolerance or drifted")


# phase 36: the graphed update against the eager one
U_F32 = 2.0 ** -24                # float32 unit roundoff
GRAPH_X_REL_TOL = 1e-6            # x, relative, where the two paths' bits differ
# phase 41's interleaved blocks of each form per configuration, and HMC
# updates per block (phases 36–40 run none since phase 41 came: PRs 12–16
# settled them, and their time pays for it). Two blocks since phase 44
# came (a third costs some 40-55 s of the script's 900 s budget): the
# median is then the mean of the two and the IQR half their distance.
GRAPH_AB_BLOCKS = 2
GRAPH_AB_UPDATES = 1


@contextlib.contextmanager
def counting_replays(timed: bool = False):
    """Count the CUDA graph replays of every graphed update inside the
    block (``box["n"]``); ``timed``: also each replay's CUDA events
    (``box["spans"]``)."""
    from elphdynamics_tpu_torch.dynamics import graphs

    box = {"n": 0, "spans": []}
    replay = graphs.UpdateGraphs.replay

    def counted(self, name):
        box["n"] += 1
        if not timed:
            return replay(self, name)
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        replay(self, name)
        b.record()
        box["spans"].append((a, b))

    graphs.UpdateGraphs.replay = counted
    try:
        yield box
    finally:
        graphs.UpdateGraphs.replay = replay


def _counted_update(step, params, state, draws):
    """One update (or Langevin step: ``state`` the fields) on ``draws``,
    every count set to 0 just before and read just after: (state, stats,
    {seconds, K1/K2 launches by form and their shapes, host reads, graph
    replays, the host reads of the graphed form's eager retries (no replay
    follows them), the peak of allocated device memory above what was
    allocated before the call})."""
    from elphdynamics_tpu_torch import solvers
    from elphdynamics_tpu_torch.ops import ckb_cuda

    def retry_reads():
        ws = step.workspace() if hasattr(step, "workspace") else None
        return 0 if ws is None else ws.retry_reads

    torch.cuda.synchronize()
    ckb_cuda.reset_counts()
    solvers.host_reads = 0
    retry0 = retry_reads()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with counting_replays() as box:
        t0 = time.perf_counter()
        out, stats = step(params, state, draws=draws)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    return out, stats, dict(seconds=seconds, launches=dict(ckb_cuda.table_launches),
                            shapes=set(ckb_cuda.launch_shapes), host_reads=solvers.host_reads,
                            replays=box["n"], retry_reads=retry_reads() - retry0,
                            peak_bytes=torch.cuda.max_memory_allocated() - base)


def _replay_busy_share(step, params, state, draws) -> dict:
    """The device's busy share of one graphed update: the summed CUDA-event
    spans of its graph replays over its wall time (the eager update's, and
    both under ``torch.profiler``: ``scripts/profile_torch_hmc.py``)."""
    torch.cuda.synchronize()
    with counting_replays(timed=True) as box:
        t0 = time.perf_counter()
        step(params, state, draws=draws)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    span = sum(a.elapsed_time(b) for a, b in box["spans"]) / 1e3
    return dict(replay_span_s=span, wall_s=wall, replay_busy_share=span / wall)


def _graph_parity(b, eager, name: str, forms=()) -> dict:
    """Two updates of ``b``'s graphed step and of its eager twin on the same
    draws from the same state: bit for bit, or x within ``GRAPH_X_REL_TOL``
    and ΔH within 2·u·(|S| + K), with equal decisions, flags and
    iterations; in both updates replays = host reads + 1 (the reads of an
    eager retry, which no replay follows, not counted); on the second (the
    first captures) equal K1 / K2 launches by form, each of ``forms`` (the
    kernel forms on the configuration's path; none on a dense Holstein
    branch) launched, and equal host reads."""
    state, out = b.state, {}
    for u in (1, 2):
        draws = eager.draw(b.params, state.x, b.state.x.shape[0], b.generator)
        sg, tg, mg = _counted_update(b.step, b.params, state, draws)
        se, te, me = _counted_update(eager, b.params, state, draws)
        pairs = [(sg.x, se.x), (sg.v, se.v), (tg.delta_H, te.delta_H)]
        if sg.defl is not None:     # the refreshed deflation basis
            pairs += [(sg.defl.W, se.defl.W), (sg.defl.chol, se.defl.chol)]
        bitwise = all(torch.equal(p, q) for p, q in pairs)
        x_rel = float((sg.x - se.x).abs().max() / se.x.abs().max())
        dH_gate = 2 * U_F32 * (te.S.abs() + te.K.abs())
        dH_ok = bool(((tg.delta_H - te.delta_H).abs() <= dH_gate).all())
        same = all(torch.equal(p, q) for p, q in ((tg.accepted, te.accepted),
                                                  (tg.iters, te.iters), (tg.flag, te.flag)))
        row = dict(bitwise=bitwise, x_rel=f"{x_rel:.3e}", dH_within_gate=dH_ok,
                   decisions_iters_flags_equal=same, graphed_s=f"{mg['seconds']:.4f}",
                   eager_s=f"{me['seconds']:.4f}", replays=mg["replays"],
                   host_reads_graphed=mg["host_reads"], host_reads_eager=me["host_reads"],
                   retry_reads=mg["retry_reads"],
                   launches_graphed={f: mg["launches"][f] for f in forms},
                   launches_eager={f: me["launches"][f] for f in forms},
                   acceptance=f"{tg.accepted.double().mean().item():.4f}",
                   cg_iters=f"{tg.iters.double().mean().item():.2f}",
                   max_flag=int(tg.flag.max()),
                   graphed_peak_mb=f"{mg['peak_bytes'] / 2**20:.1f}",
                   eager_peak_mb=f"{me['peak_bytes'] / 2**20:.1f}")
        if u == 1:
            ws = b.step.workspace()
            row.update(graphs=len(ws.graphs.graphs), capture_s=f"{ws.graphs.capture_s:.3f}",
                       pool_mb=f"{ws.graphs.pool_bytes / 2**20:.1f}")
        say(f"graph_parity_{name}", update=u, **row)
        if not (bitwise or (x_rel <= GRAPH_X_REL_TOL and dH_ok)) or not same:
            raise RuntimeError(f"graphed {name} update {u} left the eager one: {row}")
        if mg["replays"] != mg["host_reads"] - mg["retry_reads"] + 1:
            raise RuntimeError(f"graphed {name} update {u}: replays are not host reads + 1: {row}")
        if u == 2 and (mg["launches"] != me["launches"] or mg["host_reads"] != me["host_reads"]
                       or any(mg["launches"][f] <= 0 for f in forms)):
            raise RuntimeError(f"graphed {name}: launches or host reads differ, or a form "
                               f"launched no time: {row}")
        out[u] = row
        out["table_launches"], out["launch_shapes"] = mg["launches"], mg["shapes"]
        out.setdefault("accepted", []).append(tg.accepted.cpu())
        state = se
    return out


def _sweeps_ab(b, eager, n_chains: int, start, updates: int) -> dict:
    """Sweeps (or chain-steps) per second of the eager and the graphed step
    in ``GRAPH_AB_BLOCKS`` interleaved blocks each (E G G E ...), every
    block ``updates`` steps from ``start`` on one seed: medians, quartiles
    and IQRs."""
    rates = {"eager": [], "graphed": []}
    order = [("eager", "graphed")[(i // 2 + i) % 2] for i in range(2 * GRAPH_AB_BLOCKS)]
    for form in order:
        step = b.step if form == "graphed" else eager
        g = torch.Generator(device="cuda").manual_seed(17)
        state = start
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(updates):
            state, _ = step(b.params, state, g)
        torch.cuda.synchronize()
        rates[form].append(n_chains * updates / (time.perf_counter() - t0))
    out = {}
    for form, r in rates.items():
        q1, med, q3 = statistics.quantiles(r, n=4, method="inclusive")
        out[form] = dict(median=med, q1=q1, q3=q3, iqr=q3 - q1, blocks=[round(x, 4) for x in r])
    out["speedup_median"] = out["graphed"]["median"] / out["eager"]["median"]
    return out


def _graphed_update(cfg, forms, **build_kw):
    """The bench configuration ``cfg``'s graphed update against its eager
    twin: two updates each way on the same draws (:func:`_graph_parity`,
    with the kernel forms ``forms`` on its path; None runs a warm-up call of
    each instead) and the graphed update's busy share
    (:func:`_replay_busy_share`). The eager twin is the bench step's
    (:meth:`..bench.BenchStep.eager`): its own preconditioner (the same
    fixed start vectors), the model's spec and so the kernels' tuned
    geometries shared. ``build_kw`` go to :func:`..bench.build` (a cut
    ``trajectory_time``). Returns (the bench step, its eager twin, the
    results)."""
    from elphdynamics_tpu_torch.bench import build

    b = build(cfg, "cuda", torch.float32, **build_kw)
    eager = b.eager()
    if not b.step.segmented or eager.segmented:
        raise RuntimeError(f"{cfg.name}: the bench step is not the graphed update")
    res = {}
    if forms is not None:
        res["parity"] = _graph_parity(b, eager, cfg.name, forms)
    else:
        b.step(b.params, b.state, b.generator)    # warm-up and capture
        eager(b.params, b.state, b.generator)
    draws = eager.draw(b.params, b.state.x, cfg.n_chains,
                       torch.Generator(device="cuda").manual_seed(5))
    res["busy_graphed"] = _replay_busy_share(b.step, b.params, b.state, draws)
    ws = b.step.workspace()
    say(f"graph_busy_{cfg.name}", chains=cfg.n_chains, graphs=len(ws.graphs.graphs),
        capture_s=f"{ws.graphs.capture_s:.3f}", pool_mb=f"{ws.graphs.pool_bytes / 2**20:.1f}",
        graphed_replay_busy=f"{res['busy_graphed']['replay_busy_share']:.4f}")
    return b, eager, res


def _say_ab(name: str, ab: dict, per_block: str, n: int, busy: dict) -> None:
    """One line of an interleaved A/B (:func:`_sweeps_ab`)."""
    say(f"graph_ab_{name}", blocks=GRAPH_AB_BLOCKS, **{per_block: n},
        eager_median=f"{ab['eager']['median']:.4f}", eager_iqr=f"{ab['eager']['iqr']:.4f}",
        graphed_median=f"{ab['graphed']['median']:.4f}",
        graphed_iqr=f"{ab['graphed']['iqr']:.4f}",
        speedup_median=f"{ab['speedup_median']:.3f}",
        eager_blocks=ab["eager"]["blocks"], graphed_blocks=ab["graphed"]["blocks"],
        graphed_replay_busy=f"{busy['replay_busy_share']:.4f}")


def _write_json(out_file: str, out: dict) -> None:
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", out_file), "w") as f:
        json.dump(out, f, indent=1, default=str)


def phase_graphed_update() -> dict:
    """36. The graphed update (``dynamics/graphs.py``) against the eager
    one at bench 8×8 and 32×32 (the dense branch; at 32×32 cuBLAS picks its
    algorithms for N = 1024 under capture) and ``KERNEL_64X64`` (the fold
    branch: K1 and K2 inside the graphs): :func:`_graph_parity` and the
    graphed busy share (the A/B blocks went to pay for phase 40)."""
    from elphdynamics_tpu_torch.bench import BENCH_8X8, BENCH_32X32, KERNEL_64X64

    out = {cfg.name: _graphed_update(cfg, forms)[2] for cfg, forms in (
        (BENCH_8X8, ()), (BENCH_32X32, ()), (KERNEL_64X64, ("fold/shared", "fused/shared")))}
    _write_json("graphed_update.json", out)
    return out


def phase_graphed_update_ssh() -> dict:
    """37. The graphed SSH update against the eager one at ``SSH_8X8`` (the
    dense-Ā branch: K1 per-column for the fermion operator, K1 per-chain
    re-densifying each chain's Ā on every KPM refresh) and ``SSH_64X64``
    (the fold branch: K1 per-column, K1 per-chain at K = 1 for Ā's power
    iteration, K2 per-chain for every Chebyshev step), all inside the
    graphs. Bit for bit is expected: the same kernels at the same tuned
    geometries in the same order, and no atomic reduction on the path
    (SSH's alias sum gathers, ``models/ssh._tie_sum``; the bench models
    have no aliases anyway). The fallback bound of :func:`_graph_parity`
    (x within ``GRAPH_X_REL_TOL``, ΔH within 2·u·(|S| + K)) covers only a
    cuBLAS algorithm that changes under capture, on 8×8's dense Ā. No A/B
    blocks since phase 40 (they pay for it)."""
    from elphdynamics_tpu_torch.bench import SSH_8X8, SSH_64X64

    out = {cfg.name: _graphed_update(cfg, forms)[2] for cfg, forms in (
        (SSH_8X8, ("fold/column", "fold/chain")),
        (SSH_64X64, ("fold/column", "fold/chain", "fused/chain")))}
    _write_json("graphed_update_ssh.json", out)
    return out


# phase 38: the graphed Langevin step against the eager one
LANGEVIN_LONG_STEPS = 100   # graphed steps at the stock 4×4 shape; memory read after 5 and after these
LANGEVIN_REBUILDS = 3       # fresh graphed steps of that model, memory read after each


def _langevin_parity(b, eager, name: str, forms=()) -> dict:
    """Two steps of ``b``'s graphed Langevin step and of its eager twin on
    the same draws from the same fields: x bit for bit or within
    ``GRAPH_X_REL_TOL``, finite and of its shape, equal iterations and
    flags (0); in both steps replays = host reads + 1; on the second (the
    first captures) equal K1 / K2 launches by form, each of ``forms``
    launched, and equal host reads."""
    x, out = b.x, {}
    for u in (1, 2):
        draws = eager.draw(b.params, x, x.shape[0], b.generator)
        xg, tg, mg = _counted_update(b.step, b.params, x, draws)
        xe, te, me = _counted_update(eager, b.params, x, draws)
        x_rel = float((xg - xe).abs().max() / xe.abs().max())
        same = torch.equal(tg.iters, te.iters) and torch.equal(tg.flag, te.flag)
        finite = bool(torch.isfinite(xg).all()) and xg.shape == x.shape
        row = dict(bitwise=torch.equal(xg, xe), x_rel=f"{x_rel:.3e}", iters_flags_equal=same,
                   x_finite=finite, max_flag=int(tg.flag.max()),
                   cg_iters=f"{tg.iters.double().mean().item():.2f}",
                   graphed_s=f"{mg['seconds']:.4f}", eager_s=f"{me['seconds']:.4f}",
                   replays=mg["replays"], host_reads_graphed=mg["host_reads"],
                   host_reads_eager=me["host_reads"],
                   launches_graphed={f: mg["launches"][f] for f in forms},
                   launches_eager={f: me["launches"][f] for f in forms})
        if u == 1:
            ws = b.step.workspace()
            row.update(graphs=sorted(ws.graphs.graphs), capture_s=f"{ws.graphs.capture_s:.3f}",
                       pool_mb=f"{ws.graphs.pool_bytes / 2**20:.1f}")
        say(f"graph_parity_{name}", step=u, **row)
        if not (row["bitwise"] or x_rel <= GRAPH_X_REL_TOL) or not same or not finite \
                or row["max_flag"] != 0:
            raise RuntimeError(f"graphed {name} step {u} left the eager one: {row}")
        if mg["replays"] != mg["host_reads"] + 1:
            raise RuntimeError(f"graphed {name} step {u}: replays are not host reads + 1: {row}")
        if u == 2 and (mg["launches"] != me["launches"] or mg["host_reads"] != me["host_reads"]
                       or any(mg["launches"][f] <= 0 for f in forms)):
            raise RuntimeError(f"graphed {name}: launches or host reads differ, or a form "
                               f"launched no time: {row}")
        out[u] = row
        out["table_launches"], out["launch_shapes"] = mg["launches"], mg["shapes"]
        x = xe
    return out


def _langevin_memory(b) -> dict:
    """``LANGEVIN_LONG_STEPS`` graphed steps from ``b``'s fields: allocated
    device memory after step 5 and after the last (no growth allowed), x
    finite and every flag 0; then ``LANGEVIN_REBUILDS`` graphed steps built
    afresh on the same model (new workspace and graphs each, the last one
    dropped first): allocated memory after each (no growth allowed after
    the first)."""
    from elphdynamics_tpu_torch.dynamics.langevin import make_langevin_step

    g = torch.Generator(device="cuda").manual_seed(23)
    x, flag, mem = b.x, None, {}
    t0 = time.perf_counter()
    for n in range(1, LANGEVIN_LONG_STEPS + 1):
        x, st = b.step(b.params, x, g)
        flag = st.flag if flag is None else torch.maximum(flag, st.flag)
        if n in (5, LANGEVIN_LONG_STEPS):
            torch.cuda.synchronize()
            mem[n] = torch.cuda.memory_allocated()
    seconds = time.perf_counter() - t0
    rebuilt = []
    for _ in range(LANGEVIN_REBUILDS):
        step = make_langevin_step(b.ops, b.Q, b.dt, b.method, b.solver, b.precond)
        step(b.params, b.x, g)
        del step
        gc.collect()
        torch.cuda.synchronize()
        rebuilt.append(torch.cuda.memory_allocated())
    out = dict(steps=LANGEVIN_LONG_STEPS, seconds=seconds, s_per_step=seconds / LANGEVIN_LONG_STEPS,
               allocated_after_5=mem[5], allocated_after_last=mem[LANGEVIN_LONG_STEPS],
               growth_bytes=mem[LANGEVIN_LONG_STEPS] - mem[5], rebuilt_allocated=rebuilt,
               rebuild_growth_bytes=rebuilt[-1] - rebuilt[0],
               x_finite=bool(torch.isfinite(x).all()), max_flag=int(flag.max()))
    say("graphed_langevin_memory", **out)
    if out["growth_bytes"] > 0 or out["rebuild_growth_bytes"] > 0 or not out["x_finite"] \
            or out["max_flag"] != 0:
        raise RuntimeError(f"the graphed stock Langevin step grew device memory or failed: {out}")
    return out


def _cuda_memory_report() -> dict:
    """Allocated device memory against the CUDA tensors the garbage
    collector reaches, and the allocator's active blocks by memory pool:
    the default pool, or the private pools of CUDA graphs (with how many
    such pools hold any)."""
    gc.collect()
    torch.cuda.synchronize()
    storages = {}
    for o in gc.get_objects():
        if torch.is_tensor(o) and o.is_cuda:
            st = o.untyped_storage()
            storages[st.data_ptr()] = st.nbytes()
    allocated = torch.cuda.memory_allocated()
    by_pool: dict = {}
    for seg in torch.cuda.memory._snapshot()["segments"]:
        active = sum(blk["size"] for blk in seg["blocks"] if blk["state"] == "active_allocated")
        pool = tuple(seg.get("segment_pool_id", (0, 0)))
        by_pool[pool] = by_pool.get(pool, 0) + active
    graph_pools = [v for k, v in by_pool.items() if k != (0, 0) and v > 0]
    out = dict(allocated_mb=allocated / 2**20, python_tensors_mb=sum(storages.values()) / 2**20,
               held_outside_python_mb=(allocated - sum(storages.values())) / 2**20,
               default_pool_active_mb=by_pool.get((0, 0), 0) / 2**20,
               graph_pools_active_mb=sum(graph_pools) / 2**20, graph_pools_active=len(graph_pools))
    say("cuda_memory_after_graph_phases",
        **{k: (f"{v:.1f}" if isinstance(v, float) else v) for k, v in out.items()})
    return out


def _langevin_against_eager(name: str, b, eager, forms) -> dict:
    """The Langevin bench ``b``'s graphed step against its eager twin
    ``eager``: :func:`_langevin_parity` and the graphed step's busy
    share."""
    if not b.step.segmented or eager.segmented:
        raise RuntimeError(f"{name}: the Langevin step is not the graphed one")
    res = {"parity": _langevin_parity(b, eager, name, forms)}
    chains = b.x.shape[0]
    draws = eager.draw(b.params, b.x, chains, torch.Generator(device="cuda").manual_seed(5))
    res["busy_graphed"] = _replay_busy_share(b.step, b.params, b.x, draws)
    say(f"graph_busy_{name}", chains=chains, graphs=len(b.step.workspace().graphs.graphs),
        graphed_replay_busy=f"{res['busy_graphed']['replay_busy_share']:.4f}")
    return res


def phase_graphed_langevin() -> dict:
    """38. The graphed Langevin step against the eager one, asked for by
    name: ``LANGEVIN_64X64`` (16 chains, RK; K1 and K2 inside the graphs),
    ``SSH_LANGEVIN_64X64`` (8 chains, RK; K1 per-chain and per-column, K2
    per-chain) and the stock ``examples/holstein_langevin_square.toml``
    step (4×4, one chain, RK, KPM max_order 64: the host-bound extreme):
    :func:`_langevin_parity`, the graphed step's busy share (the
    interleaved blocks went to pay for phase 40), and at 4×4
    :func:`_langevin_memory`; then
    :func:`_cuda_memory_report`. JSON ``graphed_langevin.json``. Returns
    the 64×64 configurations' second graphed steps (launches, shapes)."""
    from elphdynamics_tpu_torch.bench import (
        LANGEVIN_64X64, SSH_LANGEVIN_64X64, build, build_langevin_example)

    stock = os.path.join(os.path.dirname(os.path.abspath(__file__)), "examples",
                         "holstein_langevin_square.toml")
    runs = ((LANGEVIN_64X64.name, lambda: build(LANGEVIN_64X64, "cuda", torch.float32),
             MODES["holstein"]),
            (SSH_LANGEVIN_64X64.name, lambda: build(SSH_LANGEVIN_64X64, "cuda", torch.float32),
             MODES["ssh"]),
            ("langevin_stock_4x4", lambda: build_langevin_example(stock, 1, "cuda", torch.float32),
             ()))
    out = {}
    for name, make, forms in runs:
        b = make()
        res = out[name] = _langevin_against_eager(name, b, b.eager(), forms)
        if name == "langevin_stock_4x4":
            res["memory"] = _langevin_memory(b)
        del b
    out["memory_report"] = _cuda_memory_report()
    _write_json("graphed_langevin.json", out)
    return {f"graphed_{name}": out[name]["parity"]
            for name in (LANGEVIN_64X64.name, SSH_LANGEVIN_64X64.name)}


# phase 39: the graphed reflection, swap and measurement against the eager ones
SPECIAL_MEMORY_CALLS = 50      # graphed stock 4×4 measurements, memory read after 5 and after these
BLOCKED_CHAINS = 16            # the 64×64 measurement whose estimators run in blocks of chains
# blocks against one block of all chains, relative to each result's largest
# magnitude: the same float32 arithmetic, its FFT and matmul plans chosen
# by cuFFT and cuBLAS for another batch size (so not bit for bit on a card)
BLOCKED_REL_TOL = 1e-5
SPECIAL_PARTS = ("reflect", "swap", "measure")


def _examples_dir() -> str:
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), "examples")


def _special_cases():
    """(name, parsed [hmc] file, chains, the kernel forms on its path) of
    phase 39: the stock 4×4 Holstein and SSH files at one chain, and both
    widened to 64×64, β = 4, 4 chains, nᵥ = 10 as phase 11's driver runs
    are (``bench.wide_hmc_config``)."""
    from elphdynamics_tpu_torch.bench import wide_hmc_config

    out = []
    for model, example in (("holstein", "holstein_hmc_square"), ("ssh", "ssh_hmc_square")):
        with open(os.path.join(_examples_dir(), f"{example}.toml"), "rb") as f:
            stock = tomllib.load(f)
        out += [(f"{model}_stock_4x4", stock, 1, ()),
                (f"{model}_64x64", wide_hmc_config(stock), 4, MODES[model])]
    return out


def _part_call(fn, *args, **kw):
    """One call of a move or measurement, every count set to 0 just before
    and read just after: (result, {seconds, K1/K2 launches by form and their
    shapes, host reads, graph replays})."""
    from elphdynamics_tpu_torch import solvers
    from elphdynamics_tpu_torch.ops import ckb_cuda

    torch.cuda.synchronize()
    ckb_cuda.reset_counts()
    solvers.host_reads = 0
    with counting_replays() as box:
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    return out, dict(seconds=seconds, launches=dict(ckb_cuda.table_launches),
                     shapes=set(ckb_cuda.launch_shapes), host_reads=solvers.host_reads,
                     replays=box["n"])


def _tree_equal(a, b) -> bool:
    """Nested dicts / tuples of tensors equal bit for bit (and in shape)."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_tree_equal(a[k], b[k]) for k in a)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_tree_equal(p, q) for p, q in zip(a, b))
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(a, b)


def _tree_rel_diff(a, b) -> float:
    """The largest difference of nested dicts / tuples of tensors, each
    tensor's over its own largest magnitude (0 where both are 0)."""
    if isinstance(a, dict):
        return max((_tree_rel_diff(a[k], b[k]) for k in a), default=0.0)
    if isinstance(a, (tuple, list)):
        return max((_tree_rel_diff(p, q) for p, q in zip(a, b)), default=0.0)
    a, b = a.double(), b.double()
    scale = float(b.abs().max()) if b.numel() else 0.0
    return float((a - b).abs().max()) / scale if scale > 0 else float((a - b).abs().max())


def _special_parity(ex, twin, name: str, forms, parts=SPECIAL_PARTS) -> dict:
    """Two calls of each part of ``parts`` (reflection, swap, measurement)
    of the example step ``ex`` graphed and of its eager twin on the same
    draws from the same fields: results bit for bit (x and acceptance; every increment, the
    probe solves' iterations and flags, the snapshots), replays = host reads
    + 1 in both calls, and on the second (the first captures) equal K1 / K2
    launches by form, each of ``forms`` launched, and equal host reads."""
    C = ex.state.x.shape[0]
    out = {}
    for part in parts:
        seg, eager = getattr(ex, part), getattr(twin, part)
        if part != "measure" and seg.n_moves == 0:
            continue                          # SSH's reflection: a null move
        if not seg.segmented or eager.segmented:
            raise RuntimeError(f"{name} {part}: not the segmented call")
        x, rows = ex.state.x, {}
        for u in (1, 2):
            if part == "measure":
                R = eager.draw(ex.params, x, ex.generator)
                rg, mg = _part_call(seg, ex.params, x, R=R)
                re_, me = _part_call(eager, ex.params, x, R=R)
                extra = dict(cg_iters=rg[1]["iters"].tolist(), max_flag=int(rg[1]["flag"].max()))
            else:
                draws = eager.draw(ex.params, x, C, ex.generator)
                rg, mg = _part_call(seg, ex.params, x, draws=draws)
                re_, me = _part_call(eager, ex.params, x, draws=draws)
                extra = dict(acceptance=rg[1].tolist())
            row = dict(bitwise=_tree_equal(rg, re_), graphed_s=f"{mg['seconds']:.4f}",
                       eager_s=f"{me['seconds']:.4f}", replays=mg["replays"],
                       host_reads_graphed=mg["host_reads"], host_reads_eager=me["host_reads"],
                       launches_graphed={f: mg["launches"][f] for f in forms},
                       launches_eager={f: me["launches"][f] for f in forms}, **extra)
            if u == 1:
                ws = seg.workspace()
                row.update(graphs=sorted(ws.graphs.graphs), capture_s=f"{ws.graphs.capture_s:.3f}",
                           pool_mb=f"{ws.graphs.pool_bytes / 2**20:.1f}")
            say(f"special_parity_{name}_{part}", call=u, **row)
            if not row["bitwise"] or (part == "measure" and row["max_flag"] != 0):
                raise RuntimeError(f"graphed {name} {part} call {u} left the eager one: {row}")
            if mg["replays"] != mg["host_reads"] + 1:
                raise RuntimeError(f"graphed {name} {part} call {u}: replays are not host "
                                   f"reads + 1: {row}")
            if u == 2 and (mg["launches"] != me["launches"] or mg["host_reads"] != me["host_reads"]
                           or any(mg["launches"][f] <= 0 for f in forms)):
                raise RuntimeError(f"graphed {name} {part}: launches or host reads differ, or "
                                   f"a form launched no time: {row}")
            rows[u] = row
            if part != "measure":
                x = re_[0]
        rows["table_launches"], rows["launch_shapes"] = mg["launches"], mg["shapes"]
        out[part] = rows
    return out


def _measurement_memory(ex) -> dict:
    """``SPECIAL_MEMORY_CALLS`` graphed measurements of the example's fields
    on one seed: allocated device memory after the 5th and after the last
    (no growth allowed), every flag 0."""
    g = torch.Generator(device="cuda").manual_seed(29)
    mem, flag = {}, None
    t0 = time.perf_counter()
    for n in range(1, SPECIAL_MEMORY_CALLS + 1):
        _, stats, _ = ex.measure(ex.params, ex.state.x, g)
        flag = stats["flag"] if flag is None else torch.maximum(flag, stats["flag"])
        if n in (5, SPECIAL_MEMORY_CALLS):
            torch.cuda.synchronize()
            mem[n] = torch.cuda.memory_allocated()
    seconds = time.perf_counter() - t0
    out = dict(calls=SPECIAL_MEMORY_CALLS, s_per_call=seconds / SPECIAL_MEMORY_CALLS,
               allocated_after_5=mem[5], allocated_after_last=mem[SPECIAL_MEMORY_CALLS],
               growth_bytes=mem[SPECIAL_MEMORY_CALLS] - mem[5], max_flag=int(flag.max()))
    say("graphed_measurement_memory", **out)
    if out["growth_bytes"] > 0 or out["max_flag"] != 0:
        raise RuntimeError(f"graphed measurements grew device memory or failed: {out}")
    return out


def _measurement_blocks(cfg) -> dict:
    """The measurement of the parsed ``[hmc]`` file ``cfg`` (64×64) at
    ``BLOCKED_CHAINS`` chains, whose estimators run in blocks of chains
    (``measurements.analyze_chains``; more than one block here): graphed,
    eager, and graphed in one block of every chain, on the same probes:
    equal results, replays = host reads + 1, and each graphed call's peak of
    allocated device memory above what was allocated before it, the
    blocked one below the one block's. Graphed blocks equal eager blocks
    bit for bit; against one block the libraries' plans differ with the
    batch, so that comparison holds to ``BLOCKED_REL_TOL``."""
    from elphdynamics_tpu_torch.bench import build_hmc_example
    from elphdynamics_tpu_torch.measure.measurements import analyze_chains

    ex = build_hmc_example(cfg, BLOCKED_CHAINS, "cuda", torch.float32)
    whole = build_hmc_example(cfg, BLOCKED_CHAINS, "cuda", torch.float32,
                              chain_block=BLOCKED_CHAINS)
    twin = ex.eager()
    block = analyze_chains(BLOCKED_CHAINS, ex.setup.mspec.nv, ex.ops.Nsites, ex.ops.Ltau,
                           torch.float32)
    x = ex.state.x
    R = twin.measure.draw(ex.params, x, ex.generator)
    calls, out = {}, dict(chains=BLOCKED_CHAINS, chains_per_block=block)
    for form, step in (("blocks", ex.measure), ("eager", twin.measure), ("whole", whole.measure)):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        calls[form], m = _part_call(step, ex.params, x, R=R)
        out[f"{form}_s"] = f"{m['seconds']:.4f}"
        out[f"{form}_peak_gb"] = f"{(torch.cuda.max_memory_allocated() - base) / 1e9:.3f}"
        if form != "eager":
            out[f"{form}_replays"], out[f"{form}_host_reads"] = m["replays"], m["host_reads"]
            out[f"{form}_pool_gb"] = f"{step.workspace().graphs.pool_bytes / 1e9:.3f}"
    out.update(bitwise_vs_eager=_tree_equal(calls["blocks"], calls["eager"]),
               bitwise_vs_whole=_tree_equal(calls["blocks"], calls["whole"]),
               rel_diff_vs_whole=f"{_tree_rel_diff(calls['blocks'], calls['whole']):.3e}",
               rel_tol_vs_whole=BLOCKED_REL_TOL, max_flag=int(calls["blocks"][1]["flag"].max()))
    say("blocked_measure_holstein_64x64", **out)
    if (block >= BLOCKED_CHAINS or not out["bitwise_vs_eager"]
            or float(out["rel_diff_vs_whole"]) > BLOCKED_REL_TOL
            or out["max_flag"] != 0
            or any(out[f"{f}_replays"] != out[f"{f}_host_reads"] + 1 for f in ("blocks", "whole"))
            or float(out["blocks_peak_gb"]) >= float(out["whole_peak_gb"])):
        raise RuntimeError(f"the measurement in blocks of chains left one block of all: {out}")
    return out


def phase_graphed_special_measure() -> dict:
    """39. The graphed reflection, swap and measurement (``dynamics/
    special_updates.py``, ``measure/measurements.py``: each part's segments
    as CUDA graphs) against the eager ones, asked for by name, on the stock
    ``examples/holstein_hmc_square.toml`` and ``ssh_hmc_square.toml`` driver
    steps at one chain and the same files at 64×64, β = 4, 4 chains, nᵥ =
    10 (``bench.build_hmc_example``; K1 and K2 inside the 64×64 graphs):
    :func:`_special_parity`, at stock Holstein 4×4
    :func:`_measurement_memory`, and at Holstein 64×64
    :func:`_measurement_blocks` (the interleaved blocks of seconds per part
    went to pay for phase 40). JSON ``graphed_special_measure.json``.
    Returns the 64×64 parts' second graphed calls (launches, shapes) by
    path name."""
    from elphdynamics_tpu_torch.bench import build_hmc_example

    out, paths = {}, {}
    for name, cfg, chains, forms in _special_cases():
        ex = build_hmc_example(cfg, chains, "cuda", torch.float32)
        twin = ex.eager()
        res = out[name] = {"parity": _special_parity(ex, twin, name, forms)}
        if name == "holstein_stock_4x4":
            res["memory"] = _measurement_memory(ex)
        if forms:
            for part, rows in res["parity"].items():
                paths[f"graphed_{part}_{name}"] = rows
        del ex, twin
        if name == "holstein_64x64":
            res["blocks"] = _measurement_blocks(cfg)
    _write_json("graphed_special_measure.json", out)
    return paths


# phase 40: the graphed calls under complex hopping against the eager ones
# graphed twisted 4×4 driver steps, memory read after 5 and after these
TWISTED_MEMORY_STEPS = 50
# the twisted examples ship without moves: phase 40 gives them the stock
# square files' (4 reflections and 4 swaps; SSH's reflection is a null move)
TWISTED_MOVES = {"holstein": {"reflection_update": {"freq": 1, "nsites": 4},
                              "swap_update": {"freq": 1, "nbonds": 4}},
                 "ssh": {"swap_update": {"freq": 1, "nbonds": 4}}}
TWISTED_FORMS = {"holstein": ("fold/shared/complex",),
                 "ssh": ("fold/column/complex", "fold/chain/complex")}


def _twisted_cases():
    """(name, parsed [hmc] file, chains, the kernel forms on its path) of
    phase 40: ``examples/holstein_hmc_twisted.toml`` and
    ``ssh_hmc_twisted.toml`` with ``TWISTED_MOVES``, at 4×4 and one chain
    (the trajectory cut to 0.2 for :func:`_twisted_memory`; the 4×4
    Holstein file runs dense matmuls, no kernel) and widened to 64×64, β =
    4, 4 chains, nᵥ = 10 (``bench.wide_hmc_config``)."""
    from elphdynamics_tpu_torch.bench import wide_hmc_config

    out = []
    for model in ("holstein", "ssh"):
        with open(os.path.join(_examples_dir(), f"{model}_hmc_twisted.toml"), "rb") as f:
            stock = tomllib.load(f)
        stock["hmc"].update(TWISTED_MOVES[model])
        wide = wide_hmc_config(stock)
        stock["hmc"]["trajectory_time"] = 0.2
        out += [(f"{model}_twisted_4x4", stock, 1, () if model == "holstein" else
                 TWISTED_FORMS[model]),
                (f"{model}_twisted_64x64", wide, 4, TWISTED_FORMS[model])]
    return out


def _twisted_memory(ex) -> dict:
    """``TWISTED_MEMORY_STEPS`` graphed driver steps of the example ``ex``
    (its update, moves and measurement): allocated device memory after step
    5 and after the last (no growth allowed), every flag 0."""
    g = torch.Generator(device="cuda").manual_seed(31)
    state, mem, flag = ex.state, {}, None
    t0 = time.perf_counter()
    for n in range(1, TWISTED_MEMORY_STEPS + 1):
        state, stats = ex.step(ex.params, state, g)
        x, _ = ex.reflect(ex.params, state.x, g)
        x, _ = ex.swap(ex.params, x, g)
        _, mstats, _ = ex.measure(ex.params, x, g)
        state = replace(state, x=x)
        step_flag = torch.maximum(stats.flag.max(), mstats["flag"].max())
        flag = step_flag if flag is None else torch.maximum(flag, step_flag)
        if n in (5, TWISTED_MEMORY_STEPS):
            torch.cuda.synchronize()
            mem[n] = torch.cuda.memory_allocated()
    seconds = time.perf_counter() - t0
    out = dict(steps=TWISTED_MEMORY_STEPS, s_per_step=seconds / TWISTED_MEMORY_STEPS,
               allocated_after_5=mem[5], allocated_after_last=mem[TWISTED_MEMORY_STEPS],
               growth_bytes=mem[TWISTED_MEMORY_STEPS] - mem[5], max_flag=int(flag),
               replays={p: getattr(ex, p).workspace().graphs.replays
                        for p in ("step", "reflect", "swap", "measure")
                        if getattr(ex, p).workspace() is not None})
    say("graphed_twisted_memory", **out)
    if out["growth_bytes"] > 0 or out["max_flag"] != 0:
        raise RuntimeError(f"graphed twisted driver steps grew device memory or failed: {out}")
    return out


def phase_graphed_complex() -> dict:
    """40. The graphed calls under complex hopping (``dynamics/graphs.py``:
    the same segments as a real field's, their fermion fields complex; K1's
    complex mode inside the 64×64 graphs) against the eager ones, asked for
    by name: the HMC update at ``TWISTED_64X64`` (16 chains) and
    ``SSH_TWISTED_64X64`` (8 chains; :func:`_graphed_update`), the
    RK Langevin step at ``TWISTED_LANGEVIN_64X64`` (16 chains), and the
    reflection, swap and measurement of both twisted examples at 4×4 and
    64×64 (:func:`_twisted_cases`; :func:`_special_parity`); every result
    bit for bit on the same draws, equal iterations, flags and K1 launches
    by form, replays = host reads + 1; busy shares, capture seconds and
    pool bytes (its interleaved A/B blocks, measured in PR 16, went to pay
    for phase 41); at twisted SSH 4×4
    :func:`_twisted_memory`; flags 0 and acceptance > 0 over the 64×64
    updates (phase 17's checks, whose runs this phase took over). JSON
    ``chiprun_out/graphed_complex.json``.
    Returns the 64×64 runs' (and the SSH 4×4 parts') second graphed calls
    (launches, shapes) by path name."""
    from elphdynamics_tpu_torch.bench import (
        SSH_TWISTED_64X64, TWISTED_64X64, TWISTED_LANGEVIN_64X64, build, build_hmc_example)

    paths, upd = {}, {}
    for cfg, forms in ((TWISTED_64X64, TWISTED_FORMS["holstein"]),
                       (SSH_TWISTED_64X64, TWISTED_FORMS["ssh"])):
        b, eager, res = _graphed_update(cfg, forms)
        upd[cfg.name] = res
        del b, eager
    out = {"update": upd}
    for name, res in upd.items():
        rows = [res["parity"][u] for u in (1, 2)]
        if not all(r["bitwise"] for r in rows):
            raise RuntimeError(f"graphed {name}: not bit for bit against the eager update")
        if max(r["max_flag"] for r in rows) != 0 or not any(
                float(r["acceptance"]) > 0 for r in rows):
            raise RuntimeError(f"graphed {name}: a solver flag, or no update accepted: {rows}")
        paths[f"graphed_{name}"] = res["parity"]
    b = build(TWISTED_LANGEVIN_64X64, "cuda", torch.float32)
    eager = b.eager()
    lang = out["langevin"] = _langevin_against_eager(TWISTED_LANGEVIN_64X64.name, b, eager,
                                                      TWISTED_FORMS["holstein"])
    del b, eager
    if not all(lang["parity"][u]["bitwise"] for u in (1, 2)):
        raise RuntimeError("graphed twisted Langevin: not bit for bit against the eager step")
    paths[f"graphed_{TWISTED_LANGEVIN_64X64.name}"] = lang["parity"]
    for name, cfg, chains, forms in _twisted_cases():
        ex = build_hmc_example(cfg, chains, "cuda", torch.float32)
        twin = ex.eager()
        res = out[name] = {"parity": _special_parity(ex, twin, name, forms)}
        if name == "ssh_twisted_4x4":
            res["memory"] = _twisted_memory(ex)
        if forms:
            for part, rows in res["parity"].items():
                paths[f"graphed_{part}_{name}"] = rows
        del ex, twin
    _write_json("graphed_complex.json", out)
    return paths


# phase 41: the chain-batched calls graphed (chain ranks, tempering, 2MN)
# graphed tempering 4×4 driver steps, memory read after 5 and after these
TEMPERING_MEMORY_STEPS = 50
DISPERSIVE_RERUNS = 8         # the dispersive force's old index_add form, reruns on one input
LADDER_AB_UPDATES = 2         # updates per interleaved tempering block, one exchange after them


def _exchange_call(ex, params, x, v, parity: int, draws):
    """One exchange on ``draws``, every count set to 0 just before and read
    just after: (result, {seconds, launches by form, shapes, host reads,
    replays, eager steps between replays})."""
    from elphdynamics_tpu_torch.dynamics import graphs

    graphs.collectives = 0
    out, m = _part_call(ex, params, x, v, parity, draws=draws)
    return out, dict(m, collectives=graphs.collectives)


def _exchange_parity(b, twin, name: str, forms=()) -> dict:
    """Three exchanges (parities 0, 1, 0) of ``b``'s graphed exchange and of
    its eager twin on the same draws from the same fields: x, v, the
    accepted share, iterations and flag bit for bit; replays = host reads +
    1 per run of segments between the eager gathers (one rank: none; chain
    ranks: two); from the second call (the first captures) equal K1 / K2
    launches by form and host reads, each of ``forms`` launched; seconds
    each way."""
    x, v, out = b.state.x, b.state.v, {}
    for call, parity in enumerate((0, 1, 0), start=1):
        draws = twin.draw(b.params, x, b.generator)
        rg, mg = _exchange_call(b.exchange, b.params, x, v, parity, draws)
        re_, me = _exchange_call(twin, b.params, x, v, parity, draws)
        row = dict(parity=parity, bitwise=_tree_equal(rg, re_), graphed_s=f"{mg['seconds']:.4f}",
                   eager_s=f"{me['seconds']:.4f}", replays=mg["replays"],
                   host_reads_graphed=mg["host_reads"], host_reads_eager=me["host_reads"],
                   gathers=mg["collectives"], rate=float(rg[2]), cg_iters=float(rg[3]),
                   flag=int(rg[4]), launches_graphed={f: mg["launches"][f] for f in forms},
                   launches_eager={f: me["launches"][f] for f in forms})
        if call == 1:
            ws = b.exchange.workspace()
            row.update(graphs=sorted(ws.graphs.graphs), capture_s=f"{ws.graphs.capture_s:.3f}",
                       pool_mb=f"{ws.graphs.pool_bytes / 2**20:.1f}")
        say(f"exchange_parity_{name}", call=call, **row)
        if not row["bitwise"] or row["flag"] != 0:
            raise RuntimeError(f"graphed {name} exchange {call} left the eager one: {row}")
        if mg["replays"] != mg["host_reads"] + 1 + mg["collectives"]:
            raise RuntimeError(f"graphed {name} exchange {call}: replays are not host reads + 1 "
                               f"per run between gathers: {row}")
        if call > 1 and (mg["launches"] != me["launches"] or mg["host_reads"] != me["host_reads"]
                         or any(mg["launches"][f] <= 0 for f in forms)):
            raise RuntimeError(f"graphed {name} exchange: launches or host reads differ, or a "
                               f"form launched no time: {row}")
        out[call] = row
        out["table_launches"], out["launch_shapes"] = mg["launches"], mg["shapes"]
        x, v = re_[0], re_[1]
    return out


def _ladder_ab(b, eager, eager_ex, blocks: int) -> dict:
    """Sweeps per second of a ladder's updates with their exchanges, eager
    and graphed, in ``blocks`` interleaved blocks each (E G G E ...): every
    block ``LADDER_AB_UPDATES`` updates and one exchange from the initial
    state on one seed; and each block's exchange seconds."""
    rates = {"eager": [], "graphed": []}
    ex_s = {"eager": [], "graphed": []}
    order = [("eager", "graphed")[(i // 2 + i) % 2] for i in range(2 * blocks)]
    C = b.state.x.shape[0]
    for form in order:
        step, ex = (b.step, b.exchange) if form == "graphed" else (eager, eager_ex)
        g = torch.Generator(device="cuda").manual_seed(17)
        state = b.state
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(LADDER_AB_UPDATES):
            state, _ = step(b.params, state, g)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        ex(b.params, state.x, state.v, 0, g)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        rates[form].append(C * LADDER_AB_UPDATES / (t2 - t0))
        ex_s[form].append(t2 - t1)
    out = {}
    for form in rates:
        q1, med, q3 = statistics.quantiles(rates[form], n=4, method="inclusive")
        e1, emed, e3 = statistics.quantiles(ex_s[form], n=4, method="inclusive")
        out[form] = dict(median=med, q1=q1, q3=q3, iqr=q3 - q1,
                         blocks=[round(r, 4) for r in rates[form]], exchange_s_median=emed,
                         exchange_s_iqr=e3 - e1)
    out["speedup_median"] = out["graphed"]["median"] / out["eager"]["median"]
    return out


def _old_dsbdx(spec, p, x):
    """The dispersive force as the port computed it before its fixed-order
    sum: the ωᵢⱼ pairs added by two ``index_add`` calls (on a card, atomic
    adds in no fixed order where a site ends several pairs)."""
    om2, om4 = (p.omega ** 2)[:, None], p.omega4[:, None]
    lap = torch.roll(x, 1, dims=-1) + torch.roll(x, -1, dims=-1) - 2.0 * x
    d = spec.dtau * (om2 * x + 4.0 * om4 * x ** 3) - lap / spec.dtau
    i, j = (torch.as_tensor(spec.wij_table[k], device=x.device) for k in (0, 1))
    sgn = torch.as_tensor(spec.wij_sign, dtype=x.dtype, device=x.device)[:, None]
    pair = spec.dtau * (p.wij ** 2)[:, None] * (x.index_select(-2, i) + sgn * x.index_select(-2, j))
    return d.index_add(-2, i, pair).index_add(-2, j, sgn * pair)


def _dispersive_rerun() -> dict:
    """``KERNEL_64X64``'s model with ωᵢⱼ along both bond directions (every
    site the first endpoint of two pairs, the second of two), 16 chains,
    trajectory ``SHORT_TRAJECTORY``: one graphed update run twice on the
    same draws from the same state (x, v, ΔH and decisions bit for bit), the
    fixed-order force run twice on one field (bit for bit), and the old
    ``index_add`` force ``DISPERSIVE_RERUNS`` times on that field (its
    distinct results counted: more than one is the fault the fixed order
    repairs)."""
    from elphdynamics_tpu_torch import bench
    from elphdynamics_tpu_torch.models.holstein import build_holstein, calc_dSbdx

    spec, params = build_holstein(
        bench._square(64), beta=4.0, dtau=0.1,
        t_assignments=[(1.0, 0.0, 0, 0, (1, 0, 0)), (1.0, 0.0, 0, 0, (0, 1, 0))],
        omega=1.0, lam=1.0, mu=0.0, wij_assignments=[(0.3, 0.0, 1, 0, 0, (1, 0, 0)),
                                                     (0.2, 0.0, -1, 0, 0, (0, 1, 0))],
        dtype=torch.float32, device="cuda")
    b = bench._bench_step(spec, params, 0.025, 16, torch.device("cuda"), 0, SHORT_TRAJECTORY,
                          max_order=4)
    draws = b.step.draw(b.params, b.state.x, 16, b.generator)
    runs = [b.step(b.params, b.state, draws=draws) for _ in range(2)]
    same_update = all(torch.equal(p, q) for p, q in (
        (runs[0][0].x, runs[1][0].x), (runs[0][0].v, runs[1][0].v),
        (runs[0][1].delta_H, runs[1][1].delta_H), (runs[0][1].accepted, runs[1][1].accepted)))
    x = runs[0][0].x
    same_force = torch.equal(calc_dSbdx(spec, b.params, x), calc_dSbdx(spec, b.params, x))
    old = [_old_dsbdx(spec, b.params, x) for _ in range(DISPERSIVE_RERUNS)]
    distinct = len({hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest() for t in old})
    new_vs_old = float((calc_dSbdx(spec, b.params, x) - old[0]).abs().max())
    out = dict(update_bitwise=same_update, force_bitwise=same_force,
               old_form_distinct_results=distinct, old_form_reruns=DISPERSIVE_RERUNS,
               old_form_max_abs_diff=f"{max(float((t - old[0]).abs().max()) for t in old):.3e}",
               new_vs_old_max_abs=f"{new_vs_old:.3e}",
               max_flag=int(runs[0][1].flag.max()),
               acceptance=f"{runs[0][1].accepted.double().mean().item():.4f}")
    say("dispersive_rerun_64x64", **out)
    if not (same_update and same_force) or out["max_flag"] != 0:
        raise RuntimeError(f"the dispersive 64x64 update is not the same bits on a rerun: {out}")
    return out


def _tempering_memory() -> dict:
    """``TEMPERING_MEMORY_STEPS`` graphed driver steps of the stock 4×4
    Holstein file (trajectory cut to 0.1) on 8 chains under the ladder
    ``LADDER4``: the update, the moves, an exchange (parity alternating)
    and the measurement of the rung-0 chains with their chain mean, as the
    driver runs them; allocated device memory after step 5 and after the
    last (no growth allowed), every flag 0."""
    from elphdynamics_tpu_torch.bench import build_hmc_example
    from elphdynamics_tpu_torch.dynamics.tempering import (
        TemperingConfig, ladder_params, make_exchange_step, rung_params)
    from elphdynamics_tpu_torch.measure.measurements import mean_over_chains

    with open(os.path.join(_examples_dir(), "holstein_hmc_square.toml"), "rb") as f:
        stock = tomllib.load(f)
    stock["hmc"]["trajectory_time"] = 0.1
    ex = build_hmc_example(stock, 8, "cuda", torch.float32)
    tcfg = TemperingConfig(ladder=LADDER4, freq=1)
    params = ladder_params(ex.params, tcfg, 8)
    exchange = make_exchange_step(ex.ops, tcfg, 8, ex.precond)
    g = torch.Generator(device="cuda").manual_seed(37)
    state, mem, flag, rate_sum = ex.state, {}, None, None
    t0 = time.perf_counter()
    for n in range(1, TEMPERING_MEMORY_STEPS + 1):
        state, stats = ex.step(params, state, g)
        x, _ = ex.reflect(params, state.x, g)
        x, _ = ex.swap(params, x, g)
        x, v, rate, _, ex_flag = exchange(params, x, state.v, n % 2, g)
        inc, mstats, snaps = ex.measure(rung_params(params), x[:2], g)
        mean_over_chains(inc, snaps, mstats["flag"])
        state = replace(state, x=x, v=v)
        rate_sum = rate if rate_sum is None else rate_sum + rate
        step_flag = torch.stack([f.to(torch.int64) for f in (
            stats.flag.max(), ex_flag, mstats["flag"].max())]).max()
        flag = step_flag if flag is None else torch.maximum(flag, step_flag)
        if n in (5, TEMPERING_MEMORY_STEPS):
            torch.cuda.synchronize()
            mem[n] = torch.cuda.memory_allocated()
    seconds = time.perf_counter() - t0
    out = dict(steps=TEMPERING_MEMORY_STEPS, chains=8, s_per_step=seconds / TEMPERING_MEMORY_STEPS,
               allocated_after_5=mem[5], allocated_after_last=mem[TEMPERING_MEMORY_STEPS],
               growth_bytes=mem[TEMPERING_MEMORY_STEPS] - mem[5], max_flag=int(flag),
               exchange_acceptance=f"{float(rate_sum) / TEMPERING_MEMORY_STEPS:.4f}",
               replays={p: getattr(ex, p).workspace().graphs.replays
                        for p in ("step", "reflect", "swap", "measure")}
               | {"exchange": exchange.workspace().graphs.replays})
    say("graphed_tempering_memory", **out)
    if out["growth_bytes"] > 0 or out["max_flag"] != 0:
        raise RuntimeError(f"graphed tempering driver steps grew device memory or failed: {out}")
    return out


class _BlockTwin:
    """The eager form ``fn`` of a chain rank's call, drawing the whole
    batch's numbers (``total`` chains) and keeping this rank's block along
    ``dim`` (what ``ChainBlock.wrap`` hands the graphed form)."""

    def __init__(self, fn, cb, dim: int = 0):
        self.fn, self.cb, self.dim = fn, cb, dim
        self.segmented = False

    def draw(self, params, x, n, generator):
        return self.cb.local(self.fn.draw(params, x, self.cb.total, generator), self.dim)

    def __call__(self, *args, **kw):
        return self.fn(*args, **kw)


def _rank_ab(step, eager, params, state, n_chains: int, blocks: int) -> dict:
    """:func:`_sweeps_ab` on a chain rank, every block starting at a barrier
    of the ranks so that their blocks of one form overlap: the sweeps/s of
    the whole batch (``n_chains``) over this rank's time."""
    import torch.distributed as dist

    rates = {"eager": [], "graphed": []}
    order = [("eager", "graphed")[(i // 2 + i) % 2] for i in range(2 * blocks)]
    for form in order:
        fn = step if form == "graphed" else eager
        g = torch.Generator(device=state.x.device).manual_seed(17)
        s = state
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(GRAPH_AB_UPDATES):
            s, _ = fn(params, s, generator=g)
        torch.cuda.synchronize()
        rates[form].append(n_chains * GRAPH_AB_UPDATES / (time.perf_counter() - t0))
    out = {}
    for form, r in rates.items():
        q1, med, q3 = statistics.quantiles(r, n=4, method="inclusive")
        out[form] = dict(median=med, q1=q1, q3=q3, iqr=q3 - q1, blocks=[round(x, 4) for x in r])
    return out


def _rank_graphed_chains(device) -> dict:
    """41 (chain ranks) on this rank of 2, each call graphed against its
    eager form on the same whole-batch draws cut to the rank's block:
    ``KERNEL_64X64`` (8 of 16 chains; :func:`_graph_parity`, replays and
    host reads, launches by form, then :func:`_rank_ab`), the reflection
    and swap of the stock Holstein file widened to 64×64 (4 of 8 chains;
    :func:`_special_parity`), and ``TEMPERING_64X64`` (8 of 16 chains, 2
    rungs a rank; the update and :func:`_exchange_parity`, whose gathers
    cross the ranks)."""
    from elphdynamics_tpu_torch import bench
    from elphdynamics_tpu_torch.dynamics.hmc import make_hmc_step
    from elphdynamics_tpu_torch.ops import kpm
    from elphdynamics_tpu_torch.parallel import multihost
    from elphdynamics_tpu_torch.parallel.chains import ChainBlock

    rank = multihost.rank()
    out = {}
    holstein = MODES["holstein"]
    for cfg in (bench.KERNEL_64X64, bench.TEMPERING_64X64):
        b = bench.build(cfg, device, torch.float32)
        cb = ChainBlock.of(cfg.n_chains, 2, rank)
        lb = bench.shard_bench_step(b, chains=cb)
        eager = b.eager()
        # the rank's graphed update unwrapped, so that it takes the block's draws
        raw = make_hmc_step(b.ops, b.mass, b.hmc_cfg, kpm.make_precond(b.ops, b.kpm_cfg))
        block = replace(lb, step=raw)
        res = {"update": _graph_parity(block, _BlockTwin(eager, cb), f"{cfg.name}_rank{rank}",
                                       holstein)}
        if cfg.ladder is None:
            res["ab"] = _rank_ab(cb.wrap(raw), cb.wrap(eager), lb.params, lb.state, cfg.n_chains,
                                 GRAPH_AB_BLOCKS)
        else:
            res["exchange"] = _exchange_parity(lb, lb.eager_exchange(), f"{cfg.name}_rank{rank}",
                                               holstein)
        ws = raw.workspace()
        res["pool_mb"], res["capture_s"] = ws.graphs.pool_bytes / 2 ** 20, ws.graphs.capture_s
        out[cfg.name] = res
        del b, lb, eager, raw, block
    with open(os.path.join(_examples_dir(), "holstein_hmc_square.toml"), "rb") as f:
        wide = bench.wide_hmc_config(tomllib.load(f))
    ex = bench.build_hmc_example(wide, 8, device, torch.float32)
    cb = ChainBlock.of(8, 2, rank)
    twin = ex.eager()
    block = replace(ex, state=cb.local(ex.state))
    twin_block = replace(twin, reflect=_BlockTwin(twin.reflect, cb, 1),
                         swap=_BlockTwin(twin.swap, cb, 1))
    out["moves_64x64"] = _special_parity(block, twin_block, f"moves_64x64_rank{rank}", holstein,
                                         parts=("reflect", "swap"))
    return out


def _held_to_one_rank(ranks: list, refs: dict, backend: str) -> None:
    """The chain ranks' decisions against the one-rank runs of the same
    sequence (``refs``: each configuration's :func:`_graph_parity` and, under
    the ladder, :func:`_exchange_parity` on one rank): every update's
    accepted chains, and the exchanges' accepted shares and flags. x is not
    compared bit for bit: float32 sums over a block of 8 chains add in
    another order than over 16 (phase 24)."""
    bad = []
    for name, ref in refs.items():
        runs = [r[name] for r in ranks]
        for u, want in enumerate(ref["parity"]["accepted"]):
            got = torch.cat([r["update"]["accepted"][u] for r in runs])
            if not torch.equal(got, want):
                bad.append(f"{name} update {u + 1}: {got.tolist()} against {want.tolist()}")
        if "exchange" in ref:
            want = [(ref["exchange"][c]["rate"], ref["exchange"][c]["flag"]) for c in (1, 2, 3)]
            for i, r in enumerate(runs):
                got = [(r["exchange"][c]["rate"], r["exchange"][c]["flag"]) for c in (1, 2, 3)]
                if got != want:
                    bad.append(f"{name} exchanges on rank {i}: {got} against {want}")
    say(f"chain_ranks_vs_one_rank_{backend}", configurations=sorted(refs), decisions_equal=not bad)
    if bad:
        raise RuntimeError(f"chain ranks left the one-rank run: {bad}")


def phase_graphed_chains(backend: str = "gloo", kernel_ref: dict | None = None) -> dict:
    """41. The chain-batched calls graphed (``dynamics/graphs.py``: chain
    ranks, the tempering ladder and its exchange, the 2MN integrator), each
    against its eager form asked for by name: ``KERNEL_2MN_64X64`` (16
    chains; :func:`_graphed_update`, interleaved A/B) and
    ``TEMPERING_64X64`` on one rank (the laddered update, the exchange of
    both parities, :func:`_ladder_ab`; phase 20's run and its checks); on 2
    gloo ranks sharing card 0 :func:`_rank_graphed_chains`
    (``KERNEL_64X64``'s update and A/B, the 64×64 moves,
    ``TEMPERING_64X64``'s update and exchange across the ranks), their
    decisions and exchanges held to the one-rank runs of the same sequence
    (:func:`_held_to_one_rank`; ``kernel_ref``: phase 36's
    ``KERNEL_64X64`` parity, else run here); every result bit for bit on
    the same draws, equal K1 / K2 launches by form, replays = host reads +
    1 per run of segments between the exchange's gathers;
    :func:`_dispersive_rerun`; :func:`_tempering_memory`. JSON
    ``chiprun_out/graphed_chains.json``. With ``backend`` "nccl" (a machine
    with two cards) the ranks take one card each, and of the one-rank part
    only the references run. Returns each graphed run's second call
    (launches, shapes) by path name."""
    from elphdynamics_tpu_torch.bench import KERNEL_2MN_64X64, KERNEL_64X64, TEMPERING_64X64

    holstein = MODES["holstein"]
    out, paths = {}, {}
    if backend == "gloo":
        b, eager, res = _graphed_update(KERNEL_2MN_64X64, holstein)
        ab = res["ab"] = _sweeps_ab(b, eager, KERNEL_2MN_64X64.n_chains, b.state,
                                    GRAPH_AB_UPDATES)
        _say_ab(KERNEL_2MN_64X64.name, ab, "updates_per_block", GRAPH_AB_UPDATES,
                res["busy_graphed"])
        out[KERNEL_2MN_64X64.name] = res
        paths[f"graphed_{KERNEL_2MN_64X64.name}"] = res["parity"]
        del b, eager
    b, eager, res = _graphed_update(TEMPERING_64X64, holstein)
    eager_ex = b.eager_exchange()
    res["exchange"] = _exchange_parity(b, eager_ex, TEMPERING_64X64.name, holstein)
    if backend == "gloo":
        ab = res["ab"] = _ladder_ab(b, eager, eager_ex, GRAPH_AB_BLOCKS)
        _say_ab(TEMPERING_64X64.name, ab, "updates_per_block", LADDER_AB_UPDATES,
                res["busy_graphed"])
        say(f"exchange_ab_{TEMPERING_64X64.name}",
            eager_s=f"{ab['eager']['exchange_s_median']:.4f} ({ab['eager']['exchange_s_iqr']:.4f})",
            graphed_s=f"{ab['graphed']['exchange_s_median']:.4f} "
                      f"({ab['graphed']['exchange_s_iqr']:.4f})")
        paths[f"graphed_{TEMPERING_64X64.name}"] = res["parity"]
        paths[f"graphed_exchange_{TEMPERING_64X64.name}"] = res["exchange"]
    out[TEMPERING_64X64.name] = res
    del b, eager, eager_ex
    for name in out:
        rows = [out[name]["parity"][u] for u in (1, 2)]
        if (max(r["max_flag"] for r in rows) != 0
                or not any(float(r["acceptance"]) > 0 for r in rows)):
            raise RuntimeError(f"graphed {name}: a solver flag, or no update accepted: {rows}")
    if backend == "gloo":
        out["dispersive"] = _dispersive_rerun()
        out["tempering_memory"] = _tempering_memory()
    if kernel_ref is None:
        kernel_ref = _graphed_update(KERNEL_64X64, holstein)[2]
    t0 = time.perf_counter()
    ranks = _launch(_rank_graphed_chains, 2, backend)
    _held_to_one_rank(ranks, {KERNEL_64X64.name: kernel_ref,
                              TEMPERING_64X64.name: out[TEMPERING_64X64.name]}, backend)
    per_rank = [r[KERNEL_64X64.name]["ab"] for r in ranks]
    ab = {form: {"median": min(r[form]["median"] for r in per_rank),
                 "iqr": max(r[form]["iqr"] for r in per_rank),
                 "blocks": [r[form]["blocks"] for r in per_rank]} for form in ("eager", "graphed")}
    ab["speedup_median"] = ab["graphed"]["median"] / ab["eager"]["median"]
    say(f"graph_ab_{KERNEL_64X64.name}_chain2_{backend}", ranks=2, blocks=GRAPH_AB_BLOCKS,
        eager_median=f"{ab['eager']['median']:.4f}", eager_iqr=f"{ab['eager']['iqr']:.4f}",
        graphed_median=f"{ab['graphed']['median']:.4f}", graphed_iqr=f"{ab['graphed']['iqr']:.4f}",
        speedup_median=f"{ab['speedup_median']:.3f}",
        pool_mb=[round(r[KERNEL_64X64.name]["pool_mb"], 1) for r in ranks],
        capture_s=[round(r[KERNEL_64X64.name]["capture_s"], 3) for r in ranks],
        label=repr("ranks on one card, messages staged through the host" if backend == "gloo"
                   else "one card per rank, NCCL"),
        seconds=f"{time.perf_counter() - t0:.1f}")
    out[f"chain_ranks_{backend}"] = dict(ranks=ranks, ab=ab)
    for i, r in enumerate(ranks):
        for name in (KERNEL_64X64.name, TEMPERING_64X64.name):
            paths[f"graphed_{name}_chain_rank{i}_{backend}"] = r[name]["update"]
        paths[f"graphed_exchange_{TEMPERING_64X64.name}_chain_rank{i}_{backend}"] = \
            r[TEMPERING_64X64.name]["exchange"]
        for part, rows in r["moves_64x64"].items():
            paths[f"graphed_{part}_64x64_chain_rank{i}_{backend}"] = rows
    _write_json(f"graphed_chains{'' if backend == 'gloo' else '_' + backend}.json", out)
    return paths
# phase 44 and (d): a site shard's calls graphed on NCCL site groups, their
# all-reduces and halo exchanges captured inside the graphs
SITE_RUNS = ("kernel_64x64", "ssh_64x64")
SITE_AB_BLOCKS = 3            # interleaved blocks of each form on the multi-card layouts
# the 4×4 float64 samplers of tests/torch_parallel_workers.graph_sites_worker
SITE_SMALL_CASES = ("holstein", "wij", "ssh", "twist", "ssh_twist")


class _WithDt:
    """A dynamic-dt update (or its eager twin) called at a fixed ``dt`` as
    an ordinary update."""

    def __init__(self, step, dt):
        self.step, self.dt = step, dt
        self.segmented = step.segmented

    def draw(self, *args):
        return self.step.draw(*args)

    def workspace(self):
        return self.step.workspace() if hasattr(self.step, "workspace") else None

    def __call__(self, params, state, generator=None, draws=None):
        return self.step(params, state, self.dt, generator, draws)


def _site_layout(n_chain: int, n_site: int, n_chains: int, spec):
    """:func:`_layout`, with a site shard at ``n_site`` = 1 too: a one-rank
    site group holding every site (no halo; every all-reduce an NCCL op)."""
    if n_site > 1:
        return _layout(n_chain, n_site, n_chains, spec)
    from elphdynamics_tpu_torch.parallel.lattice_shard import SiteShard

    return None, SiteShard(spec.ckb, getattr(spec, "wij_table", None), 1, 0)


def _shard_counts(shard) -> dict:
    from elphdynamics_tpu_torch.parallel.lattice_shard import COUNTERS

    return {k: getattr(shard, k) for k in COUNTERS}


def _site_parity(step, twin, lb, shard, n_chains: int, tag: str, updates: int = 2) -> dict:
    """``updates`` updates of a site shard's graphed ``step`` and of its
    eager ``twin`` on the same draws (the whole batch's, cut to the rank's
    chains and sites) from the same state: bit for bit (x, v, ΔH,
    decisions, iterations, flags), equal host reads and shard counters
    (those of the graphed update added at each replay), replays = host
    reads + 1 (an eager retry's reads not counted); the counters equal
    from the second update on (the first also counts the warm-up, every
    segment once, eagerly). Per update: the row,
    the decisions, iterations and (SSH) a hash of the whole bond field."""
    state, out = lb.state, {}
    for u in range(1, updates + 1):
        draws = twin.draw(lb.params, state.x, n_chains, lb.generator)
        shard.reset_counts()
        sg, tg, mg = _counted_update(step, lb.params, state, draws)
        cg = _shard_counts(shard)
        shard.reset_counts()
        se, te, me = _counted_update(twin, lb.params, state, draws)
        ce = _shard_counts(shard)
        bitwise = all(torch.equal(p, q) for p, q in (
            (sg.x, se.x), (sg.v, se.v), (tg.delta_H, te.delta_H), (tg.accepted, te.accepted),
            (tg.iters, te.iters), (tg.flag, te.flag)))
        row = dict(bitwise=bitwise, counters_equal=cg == ce, replays=mg["replays"],
                   host_reads=mg["host_reads"], host_reads_eager=me["host_reads"],
                   retry_reads=mg["retry_reads"], graphed_s=f"{mg['seconds']:.4f}",
                   eager_s=f"{me['seconds']:.4f}", allreduces=cg["allreduces"],
                   halo_msgs=cg["halo_msgs"], folds=cg["folds"], force_sums=cg["force_sums"],
                   max_flag=int(tg.flag.max()), finite=bool(torch.isfinite(sg.x).all()))
        say(f"site_parity_{tag}", update=u, **row)
        # the first graphed call also counts its warm-up (every segment run
        # once eagerly), which ran on the card; from the second on the counts
        # are the replays' alone
        if not (bitwise and (u == 1 or row["counters_equal"]) and row["finite"]
                and row["max_flag"] == 0):
            raise RuntimeError(f"{tag} update {u}: the graphed site-sharded update left the "
                               f"eager one, or flagged: {row} {cg} {ce}")
        if ((sg.x.is_cuda and mg["replays"] != mg["host_reads"] - mg["retry_reads"] + 1)
                or mg["host_reads"] != me["host_reads"]):
            raise RuntimeError(f"{tag} update {u}: replays are not host reads + 1, or the "
                               f"host reads differ: {row}")
        row.update(accepted=tg.accepted.cpu().tolist(), iters=tg.iters.cpu().tolist(),
                   field_sha256=(hashlib.sha256(sg.x.cpu().numpy().tobytes()).hexdigest()
                                 if not lb.ops.is_holstein else None))
        out[u] = row
        state = se
    return out


def _rank_graphed_sites(device, n_chain: int, n_site: int, names, blocks: int,
                        dyn: bool) -> dict:
    """44 / (d) on this rank of the ``n_chain`` × ``n_site`` layout (NCCL,
    one card per rank): per configuration of ``names`` (float32, trajectory
    cut to ``SHORT_TRAJECTORY``) the site-sharded update graphed against
    its eager form (:func:`_site_parity`); with ``dyn`` the dt tuner's
    update too; with ``blocks`` the interleaved A/B of the whole batch's
    sweeps/s (:func:`_rank_ab`) and the graphed update's busy share. Per
    configuration also the graphs, their pool and capture seconds, and the
    all-reduces and halo messages each graph holds (counted at its capture,
    added at each replay)."""
    from elphdynamics_tpu_torch import bench
    from elphdynamics_tpu_torch.dynamics.hmc import make_hmc_step
    from elphdynamics_tpu_torch.parallel import multihost

    rank, out = multihost.rank(), {}
    for name in names:
        cfg = getattr(bench, name.upper())
        b = bench.build(cfg, device, torch.float32, trajectory_time=SHORT_TRAJECTORY)
        cb, shard = _site_layout(n_chain, n_site, cfg.n_chains, b.ops.spec)
        lb = bench.shard_bench_step(b, shard, cb)
        raw = make_hmc_step(lb.ops, lb.mass, lb.hmc_cfg, lb.precond())
        eager = lb.eager()
        twin = eager if cb is None else _BlockTwin(eager, cb)
        tag = f"{name}_{n_chain}x{n_site}_rank{rank}"
        res = {"update": _site_parity(raw, twin, lb, shard, cfg.n_chains, tag)}
        if dyn:
            dt = torch.tensor(lb.hmc_cfg.dt, dtype=torch.float64, device=device)
            dstep = make_hmc_step(lb.ops, lb.mass, lb.hmc_cfg, lb.precond(), dynamic_dt=True)
            deager = make_hmc_step(lb.ops, lb.mass, lb.hmc_cfg, lb.precond(), dynamic_dt=True,
                                   eager=True)
            dtwin = _WithDt(deager, dt)
            res["update_dt"] = _site_parity(_WithDt(dstep, dt), dtwin if cb is None
                                            else _BlockTwin(dtwin, cb), lb, shard,
                                            cfg.n_chains, f"{tag}_dt", updates=1)
        ws = raw.workspace()
        if ws.graphs is not None:
            res.update(graphs=len(ws.graphs.graphs), capture_s=ws.graphs.capture_s,
                       pool_mb=ws.graphs.pool_bytes / 2 ** 20,
                       per_replay={g: (srec.per_replay("allreduces"),
                                       srec.per_replay("halo_msgs"))
                                   for g, (_, srec) in ws.graphs.graphs.items()})
        if blocks:
            run, run_eager = (raw, eager) if cb is None else (cb.wrap(raw), cb.wrap(eager))
            res["ab"] = _rank_ab(run, run_eager, lb.params, lb.state, cfg.n_chains, blocks)
            draws = twin.draw(lb.params, lb.state.x, cfg.n_chains,
                              torch.Generator(device=device).manual_seed(5))
            res["busy"] = _replay_busy_share(raw, lb.params, lb.state, draws)
        out[name] = res
        del b, lb, raw, eager, twin, ws
        gc.collect()
        torch.cuda.empty_cache()
    return out


def _site_groups_agree(ranks: list, n_site: int, name: str) -> bool:
    """The ranks of each site group took the same decisions, iterations,
    host reads and replays in every update, and (SSH) hold the same bond
    field bit for bit."""
    groups = [ranks[i:i + n_site] for i in range(0, len(ranks), n_site)]
    keys = ("accepted", "iters", "host_reads", "replays", "field_sha256")
    return all(r[name][part][u][k] == g[0][name][part][u][k]
               for g in groups for r in g for part in ("update", "update_dt")
               if part in g[0][name] for u in g[0][name][part] for k in keys)


def phase_graphed_sites_one_card() -> dict:
    """44. A one-rank NCCL site group on card 0 (``multihost.launch(fn, 1,
    "nccl")``): a D = 1 site shard of ``KERNEL_64X64`` and of ``SSH_64X64``
    (every site in the block, so no halo; every all-reduce an NCCL op
    captured inside the graphs), trajectories cut to ``SHORT_TRAJECTORY``,
    two updates each graphed against the eager form, bit for bit, with
    equal shard counters in the second, replays = host reads + 1, and the
    all-reduces
    each graph holds per replay. JSON ``chiprun_out/graphed_sites.json``."""
    t0 = time.perf_counter()
    r = _launch(_rank_graphed_sites, 1, "nccl", (1, 1, SITE_RUNS, 0, False))[0]
    for name in SITE_RUNS:
        res = r[name]
        rows = [res["update"][u] for u in (1, 2)]
        say(f"graphed_sites_{name}_1x1_nccl", bitwise=all(x["bitwise"] for x in rows),
            counters_equal_second_update=rows[1]["counters_equal"],
            replays=[x["replays"] for x in rows], host_reads=[x["host_reads"] for x in rows],
            allreduces=[x["allreduces"] for x in rows], graphs=res["graphs"],
            capture_s=f"{res['capture_s']:.3f}", pool_mb=f"{res['pool_mb']:.1f}",
            allreduces_per_replay={g: a for g, (a, _) in res["per_replay"].items()},
            graphed_s=[x["graphed_s"] for x in rows], eager_s=[x["eager_s"] for x in rows])
        if sum(a for a, _ in res["per_replay"].values()) <= 0:
            raise RuntimeError(f"{name}: no all-reduce inside the graphs of a site shard")
    say("graphed_sites_1x1_nccl", seconds=f"{time.perf_counter() - t0:.1f}")
    _write_json("graphed_sites.json", r)
    return r


def _one_rank_rates(cfg, blocks: int) -> dict:
    """Sweeps/s of ``cfg``'s graphed one-rank update (float32, trajectory
    cut to ``SHORT_TRAJECTORY``) in ``blocks`` blocks of
    ``GRAPH_AB_UPDATES`` updates after a warm-up: median, IQR."""
    from elphdynamics_tpu_torch import bench

    b = bench.build(cfg, "cuda", torch.float32, trajectory_time=SHORT_TRAJECTORY)
    state, _ = b.step(b.params, b.state, b.generator)
    rates = []
    for _ in range(blocks):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(GRAPH_AB_UPDATES):
            state, _ = b.step(b.params, state, b.generator)
        torch.cuda.synchronize()
        rates.append(cfg.n_chains * GRAPH_AB_UPDATES / (time.perf_counter() - t0))
    q1, med, q3 = statistics.quantiles(rates, n=4, method="inclusive")
    return dict(median=med, iqr=q3 - q1, blocks=[round(x, 4) for x in rates])


def _say_graphed_sites(layout: str, ranks: list, n_site: int, refs: dict) -> list:
    """The lines of a multi-card :func:`_rank_graphed_sites` run: per
    configuration the site groups' agreement, the A/B (the slowest rank's
    median, the widest IQR) beside one rank's graphed update of the same
    chains (``refs``), busy shares, replays, host reads, pool and capture
    seconds. Returns the configurations whose site groups disagree."""
    bad = []
    for name in ranks[0]:
        agree = _site_groups_agree(ranks, n_site, name)
        per = [r[name]["ab"] for r in ranks]
        ab = {form: dict(median=min(p[form]["median"] for p in per),
                         iqr=max(p[form]["iqr"] for p in per)) for form in ("eager", "graphed")}
        one = refs[name]
        rows = ranks[0][name]["update"]
        say(f"graphed_sites_{name}_{layout}_nccl", ranks=len(ranks), site_groups_agree=agree,
            graphed_sweeps_per_s=f"{ab['graphed']['median']:.4f}",
            graphed_iqr=f"{ab['graphed']['iqr']:.4f}",
            eager_sweeps_per_s=f"{ab['eager']['median']:.4f}",
            eager_iqr=f"{ab['eager']['iqr']:.4f}",
            graphed_over_eager=f"{ab['graphed']['median'] / ab['eager']['median']:.3f}",
            one_rank_graphed_sweeps_per_s=f"{one['median']:.4f}",
            one_rank_iqr=f"{one['iqr']:.4f}",
            graphed_over_one_rank=f"{ab['graphed']['median'] / one['median']:.3f}",
            busy=[round(r[name]["busy"]["replay_busy_share"], 4) for r in ranks],
            replays=[rows[u]["replays"] for u in rows],
            host_reads=[rows[u]["host_reads"] for u in rows],
            allreduces=[rows[u]["allreduces"] for u in rows],
            halo_msgs=[rows[u]["halo_msgs"] for u in rows],
            pool_mb=[round(r[name]["pool_mb"], 1) for r in ranks],
            capture_s=[round(r[name]["capture_s"], 3) for r in ranks],
            graphs=ranks[0][name]["graphs"], blocks=SITE_AB_BLOCKS,
            label=repr("one card per rank, NCCL"))
        if not agree:
            bad.append(f"{name}_{layout}")
    return bad


def _say_site_small_graphed(layout: str, ranks: list, n_site: int) -> list:
    """The lines of :func:`torch_parallel_workers.graph_sites_worker` on NCCL
    ranks (4×4 float64): every call bit for bit its eager form, replays =
    host reads − retry reads + 1 + eager steps between replays, the ranks
    of a site group agreeing on host reads, replays and counters. Returns
    the calls that failed."""
    bad = []
    for name in ranks[0]:
        rows = [r[name] for r in ranks]
        groups = [rows[i:i + n_site] for i in range(0, len(rows), n_site)]
        same = all(x["same"] and x["segmented"] for x in rows)
        replays_ok = all(x["replays"] == x["reads"] - x["retry_reads"] + 1 + x["collectives"]
                         for x in rows)
        agree = all(x[k] == g[0][k] for g in groups for x in g
                    for k in ("reads", "replays", "counts"))
        say(f"site_small_graphed_{name}_{layout}_nccl", bitwise_vs_eager=same,
            replays=rows[0]["replays"], host_reads=rows[0]["reads"],
            replays_are_reads_plus_one=replays_ok, site_groups_agree=agree,
            allreduces=rows[0]["counts"]["allreduces"], halo_msgs=rows[0]["counts"]["halo_msgs"])
        if not (same and replays_ok and agree):
            bad.append(f"{name}_{layout}")
    return bad


HALO_REPS = 20                # eager exchanges in the halo probe


def _rank_halo(device) -> dict:
    """(d) The halo of ``SSH_64X64``'s fermion fields ([8, 2, B, 40]
    float32) on this rank of a site group of every rank, through
    ``comm.halo_exchange`` (``batch_isend_irecv``): each crossing group's
    exchange timed eagerly (``HALO_REPS`` rounds of every crossing group,
    each round from a barrier, median and IQR per exchange), then one round
    captured in a CUDA graph on the capture stream (after an eager round
    there) and replayed, its rows against the eager ones bit for bit."""
    import torch.distributed as dist

    from elphdynamics_tpu_torch import bench
    from elphdynamics_tpu_torch.dynamics.graphs import capture_stream
    from elphdynamics_tpu_torch.parallel import comm, multihost
    from elphdynamics_tpu_torch.parallel.lattice_shard import SiteShard

    cfg = bench.SSH_64X64
    b = bench.build(cfg, device, torch.float32)
    world, rank = multihost.world(), multihost.rank()
    shard = SiteShard(b.ops.spec.ckb, None, world, rank)
    p, tabs = shard.plan, shard._dev_tables(device)
    g = torch.Generator(device=device).manual_seed(3 + rank)
    v = torch.randn((cfg.n_chains, 2, shard.B, b.ops.Ltau), generator=g, device=device)
    crossing = [k for k in range(p.ngroups) if p.hp[k] or p.hn[k]]

    def round_():
        rows = []
        for k in crossing:
            sn = v.index_select(-2, tabs["send_next"][k]) if p.hp[k] else None
            sp = v.index_select(-2, tabs["send_prev"][k]) if p.hn[k] else None
            rows += [t for t in comm.halo_exchange(sn, sp, shard.next_rank, shard.prev_rank)
                     if t is not None]
        return rows

    eager_rows = round_()
    times = []
    for _ in range(HALO_REPS):
        dist.barrier()
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        round_()
        torch.cuda.synchronize(device)
        times.append((time.perf_counter() - t0) / max(len(crossing), 1) * 1e3)
    q1, med, q3 = statistics.quantiles(times, n=4, method="inclusive")
    stream = capture_stream(device)
    stream.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(stream):
        round_()
    torch.cuda.synchronize(device)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        captured = round_()
    graph.replay()
    torch.cuda.synchronize(device)
    return {"groups": len(crossing), "rows": len(eager_rows),
            "bytes_sent_per_exchange": sum(
                (p.hp[k] + p.hn[k]) * v[..., :1, :].numel() * v.element_size()
                for k in crossing) / max(len(crossing), 1),
            "eager_ms": med, "eager_iqr_ms": q3 - q1,
            "captured_equals_eager": len(captured) == len(eager_rows) > 0 and all(
                torch.equal(a, c) for a, c in zip(eager_rows, captured))}


def phase_halo() -> dict:
    """(d) :func:`_rank_halo` on 2 NCCL ranks: the slowest rank's median
    per exchange; fails unless every rank's captured exchange delivers the
    eager rows."""
    ranks = _launch(_rank_halo, 2, "nccl")
    r = ranks[0]
    ok = all(x["captured_equals_eager"] for x in ranks)
    say("halo_p2p_ssh_64x64_nccl", ranks=2, groups=r["groups"],
        bytes_sent_per_exchange=r["bytes_sent_per_exchange"],
        eager_ms_per_exchange=f"{max(x['eager_ms'] for x in ranks):.4f}",
        eager_iqr_ms=f"{max(x['eager_iqr_ms'] for x in ranks):.4f}",
        captured_equals_eager=ok)
    if not ok:
        raise RuntimeError("a captured halo exchange differs from the eager one")
    return {"ranks": ranks}


def phase_graphed_sites_nccl(n: int) -> dict:
    """(d) The site-sharded calls graphed on NCCL site groups, one card per
    rank: the halo captured and timed (:func:`phase_halo`), the 4×4 float64
    samplers of
    ``tests/torch_parallel_workers.graph_sites_worker`` on 2 site ranks
    (and the laddered update and exchange on 2×2 with four cards), then
    ``KERNEL_64X64`` and ``SSH_64X64`` at D = 2 (the dt tuner's update too)
    and, with four cards, ``KERNEL_64X64`` on 2×2: each against its eager
    form bit for bit (:func:`_rank_graphed_sites`), the ranks of a site
    group agreeing, sweeps/s of graphed against eager and against one
    rank's graphed update of the same chains. JSON
    ``chiprun_out/graphed_sites_nccl.json``."""
    from elphdynamics_tpu_torch import bench

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
    import torch_parallel_workers as W

    t0 = time.perf_counter()
    halo = phase_halo()
    bad = _say_site_small_graphed("1x2", _launch(W.graph_sites_worker, 2, "nccl",
                                                 (1, SITE_SMALL_CASES)), 2)
    if n >= 4:
        bad += _say_site_small_graphed("2x2", _launch(W.graph_sites_worker, 4, "nccl",
                                                      (2, ("ladder",), 4)), 2)
    refs = {name: _one_rank_rates(getattr(bench, name.upper()), SITE_AB_BLOCKS)
            for name in SITE_RUNS}
    runs = {"1x2": _launch(_rank_graphed_sites, 2, "nccl",
                           (1, 2, SITE_RUNS, SITE_AB_BLOCKS, True))}
    if n >= 4:
        runs["2x2"] = _launch(_rank_graphed_sites, 4, "nccl",
                              (2, 2, ("kernel_64x64",), SITE_AB_BLOCKS, False))
    for layout, ranks in runs.items():
        bad += _say_graphed_sites(layout, ranks, 2, refs)
    say("graphed_sites_nccl", seconds=f"{time.perf_counter() - t0:.1f}")
    _write_json("graphed_sites_nccl.json", dict(halo=halo, refs=refs, runs=runs))
    if bad:
        raise RuntimeError(f"graphed site-sharded runs failed: {bad}")
    return runs


# phase 42: the CG solver aids graphed (block CG, deflation, near-null, the
# exact low-frequency blocks) against their eager forms
AIDS_MEMORY_UPDATES = 50      # graphed deflated 4×4 updates, memory read after 5 and after these
AIDS_PROBES = 10              # nᵥ of the block-probe runs


def _calls_ab(graphed, eager) -> dict:
    """Seconds per call of two argument-free callables in
    ``GRAPH_AB_BLOCKS`` interleaved blocks each (E G G E ...), one call a
    block: medians, quartiles and IQRs."""
    secs = {"eager": [], "graphed": []}
    order = [("eager", "graphed")[(i // 2 + i) % 2] for i in range(2 * GRAPH_AB_BLOCKS)]
    for form in order:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (graphed if form == "graphed" else eager)()
        torch.cuda.synchronize()
        secs[form].append(time.perf_counter() - t0)
    out = {}
    for form, r in secs.items():
        q1, med, q3 = statistics.quantiles(r, n=4, method="inclusive")
        out[form] = dict(median=med, q1=q1, q3=q3, iqr=q3 - q1, blocks=[round(x, 4) for x in r])
    out["speedup_median"] = out["eager"]["median"] / out["graphed"]["median"]
    return out


def _aid_updates() -> dict:
    """The four aid configurations' updates graphed against eager: parity
    (:func:`_graph_parity`, the refreshed deflation basis included), busy
    share, interleaved sweeps/s blocks; flags 0 and acceptance > 0 over the
    parity updates."""
    from elphdynamics_tpu_torch.bench import (
        BLOCK_64X64, DEFLATED_64X64, LOWFREQ_32X32, NEARNULL_64X64)

    out = {}
    for cfg, forms in ((BLOCK_64X64, MODES["holstein"]), (DEFLATED_64X64, MODES["holstein"]),
                       (NEARNULL_64X64, MODES["holstein"]), (LOWFREQ_32X32, ())):
        b, eager, res = _graphed_update(cfg, forms)
        par = res["parity"]
        acc = float(torch.cat(par["accepted"]).double().mean())
        flag = max(par[u]["max_flag"] for u in (1, 2))
        ab = _sweeps_ab(b, eager, cfg.n_chains, b.state, GRAPH_AB_UPDATES)
        _say_ab(cfg.name, ab, "updates_per_block", GRAPH_AB_UPDATES, res["busy_graphed"])
        ws = b.step.workspace()
        res.update(ab=ab, acceptance=acc, max_flag=flag, graphs=sorted(ws.graphs.graphs),
                   pool_bytes=ws.graphs.pool_bytes, capture_s=ws.graphs.capture_s)
        say(f"graphed_aid_{cfg.name}", acceptance=f"{acc:.4f}", max_flag=flag,
            graphs=sorted(ws.graphs.graphs))
        if flag != 0 or not acc > 0:
            raise RuntimeError(f"{cfg.name}: flag {flag}, acceptance {acc}")
        out[cfg.name] = res
        del b, eager, ws
        gc.collect()
        torch.cuda.empty_cache()
    return out


def _block_measure_64() -> dict:
    """The 64×64 Holstein measurement (the stock file widened, 4 chains,
    nᵥ = 10) with ``[solver] block``: block CG over each chain's probes
    (s = 10), graphed against eager (:func:`_special_parity`) and seconds
    per call in interleaved blocks."""
    from elphdynamics_tpu_torch.bench import build_hmc_example, wide_hmc_config

    with open(os.path.join(_examples_dir(), "holstein_hmc_square.toml"), "rb") as f:
        cfg = wide_hmc_config(tomllib.load(f))
    cfg["solver"]["block"] = True
    ex = build_hmc_example(cfg, 4, "cuda", torch.float32)
    twin = ex.eager()
    rows = _special_parity(ex, twin, "block_64x64", MODES["holstein"], parts=("measure",))
    x, g = ex.state.x, torch.Generator(device="cuda").manual_seed(23)
    R = twin.measure.draw(ex.params, x, g)
    ab = _calls_ab(lambda: ex.measure(ex.params, x, R=R), lambda: twin.measure(ex.params, x, R=R))
    ws = ex.measure.workspace()
    say("graph_ab_block_measure_64x64", chains=4, nv=ex.setup.mspec.nv,
        eager_median_s=f"{ab['eager']['median']:.4f}", eager_iqr=f"{ab['eager']['iqr']:.4f}",
        graphed_median_s=f"{ab['graphed']['median']:.4f}",
        graphed_iqr=f"{ab['graphed']['iqr']:.4f}", speedup_median=f"{ab['speedup_median']:.3f}",
        pool_mb=f"{ws.graphs.pool_bytes / 2**20:.1f}", graphs=sorted(ws.graphs.graphs))
    if "bcg" not in ws or ws.bcg.x.shape[1] != ex.setup.mspec.nv:
        raise RuntimeError("the 64x64 block measurement did not solve by block CG")
    return dict(parity=rows["measure"], ab=ab, pool_bytes=ws.graphs.pool_bytes)


def _twisted_block_probes() -> dict:
    """Block CG on complex fields at full width (phase 31's checks, graphed):
    nᵥ = 10 circular complex probes per chain on ``TWISTED_64X64`` (16
    chains) and ``SSH_TWISTED_64X64`` (8), complex64, tol 1e-5, through the
    graphed measurement with ``[solver] block`` (Hermitian block CG,
    s = nᵥ) and with CG on the same probes: the block call bit for bit
    against its eager twin with replays = host reads + 1, flags 0, the
    recomputed ‖M·X − R‖/‖R‖ of every system ≤ √tol, block and CG within
    ``BLOCK_VS_CG_GATE`` and each of the model's complex K1 forms launched
    by the block call. Returns each block call's launches and shapes."""
    from elphdynamics_tpu_torch.bench import SSH_TWISTED_64X64, TWISTED_64X64, build
    from elphdynamics_tpu_torch.dynamics.solve import SolverConfig
    from elphdynamics_tpu_torch.measure.measurements import MeasurementSpec, make_measurement_step
    from elphdynamics_tpu_torch.ops import kpm
    from elphdynamics_tpu_torch.utils.dtypes import fdot, trace_noise

    tol, out, bad = 1e-5, {}, []
    for cfg, forms in ((TWISTED_64X64, ("fold/shared/complex",)),
                       (SSH_TWISTED_64X64, ("fold/column/complex", "fold/chain/complex"))):
        b = build(cfg, "cuda", torch.float32)
        ops, params, x = b.ops, b.params, b.state.x
        C = x.shape[0]
        R = trace_noise((C, AIDS_PROBES, ops.Nsites, ops.Ltau), torch.complex64, "cuda",
                        torch.Generator(device="cuda").manual_seed(8))
        mspec = MeasurementSpec(nv=AIDS_PROBES)
        sols, runs = {}, {}
        for kind, block in (("block_cg", True), ("cg", False)):
            scfg = SolverConfig(tol=tol, maxiter=500, block=block)
            step = make_measurement_step(ops, mspec, scfg, kpm.make_precond(ops, b.kpm_cfg))
            step(params, x, R=R)                       # warm-up and capture
            res, m = _part_call(step, params, x, R=R)
            ws = step.workspace()
            X = (ws.bcg if block else ws.cg).x.clone()
            d = ops.mulM(params, ops.stack(ops.derived(params, x)), X) - R
            resid = torch.sqrt(fdot(d, d) / fdot(R, R))
            sols[kind] = X
            row = dict(config=cfg.name, kind=kind, chains=C, systems=C * AIDS_PROBES,
                       dtype="complex64", tol=tol,
                       iters_mean=f"{res[1]['iters'].double().mean().item():.2f}",
                       seconds=f"{m['seconds']:.4f}", max_flag=int(res[1]["flag"].max()),
                       max_residual_M=f"{resid.max().item():.3e}",
                       residual_gate=f"{math.sqrt(tol):.3e}", replays=m["replays"],
                       host_reads=m["host_reads"],
                       k1_complex_launches={f: m["launches"][f] for f in COMPLEX_MODES})
            if block:
                twin = make_measurement_step(ops, mspec, scfg, kpm.make_precond(ops, b.kpm_cfg),
                                             eager=True)
                eres, me = _part_call(twin, params, x, R=R)
                row.update(bitwise=_tree_equal(res, eres), eager_seconds=f"{me['seconds']:.4f}",
                           pool_mb=f"{ws.graphs.pool_bytes / 2**20:.1f}")
                runs[kind] = dict(table_launches=m["launches"], launch_shapes=m["shapes"])
                if (not row["bitwise"] or m["replays"] != m["host_reads"] + 1
                        or m["launches"] != me["launches"]
                        or any(m["launches"][f] <= 0 for f in forms)):
                    bad.append(f"{cfg.name}/block: {row}")
            say("block_complex_64x64", **row)
            if row["max_flag"] != 0 or not resid.max().item() <= math.sqrt(tol):
                bad.append(f"{cfg.name}/{kind}: flag or residual")
            del step, ws
        diff = torch.sqrt(fdot(sols["block_cg"] - sols["cg"], sols["block_cg"] - sols["cg"])
                          / fdot(sols["cg"], sols["cg"])).max().item()
        say("block_complex_64x64", config=cfg.name, max_rel_diff_block_vs_cg=f"{diff:.3e}",
            gate=BLOCK_VS_CG_GATE)
        if not diff <= BLOCK_VS_CG_GATE:
            bad.append(f"{cfg.name}: block and CG {diff:.3e} apart")
        out[f"block_cg_{cfg.name}"] = runs["block_cg"]
        del b
        gc.collect()
    if bad:
        raise RuntimeError(f"graphed block CG on complex fields at 64x64: {bad}")
    return out


def _deep_beta_graphed() -> dict:
    """``bench.DEEP_BETA_64X64``'s three solve kinds (plain KPM-CG, with
    deflation, with the near-null preconditioner; 64×64, β = 16, Lτ = 160,
    4 chains × 2 spins, float32), graphed (the set-up, its basis refreshes
    and the solve's start one segment, the CG blocks and verification
    others) against eager: each graphed call twice (the first captures),
    then the eager twin; set-up and solve seconds each way, iterations,
    flags, peak memory, replays = host reads + 1, the replays' busy share,
    the pool and capture seconds, equal K1 / K2 launches by form. Results
    bit for bit, or x within ``GRAPH_X_REL_TOL`` with equal iterations and
    flags."""
    from elphdynamics_tpu_torch import solvers
    from elphdynamics_tpu_torch.bench import DEEP_BETA_64X64, SOLVE_KINDS, build_deep_beta_solves
    from elphdynamics_tpu_torch.ops import ckb_cuda

    d = build_deep_beta_solves(DEEP_BETA_64X64, "cuda", torch.float32)
    out, launches, shapes = {}, {}, set()

    def timed(kind, eager, spans=False):
        torch.cuda.synchronize()
        ckb_cuda.reset_counts()
        solvers.host_reads = 0
        torch.cuda.reset_peak_memory_stats()
        with counting_replays(timed=spans) as box:
            t0 = time.perf_counter()
            run = d.prepare(kind, eager=eager)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            res = run()
            torch.cuda.synchronize()
            t2 = time.perf_counter()
        busy = (sum(a.elapsed_time(b) for a, b in box["spans"]) / 1e3 / (t2 - t0)
                if spans else None)
        return run, res, dict(setup_s=t1 - t0, solve_s=t2 - t1, replays=box["n"],
                              host_reads=solvers.host_reads, busy=busy,
                              launches=dict(ckb_cuda.table_launches),
                              shapes=set(ckb_cuda.launch_shapes),
                              peak_gb=torch.cuda.max_memory_allocated() / 1e9)

    for kind in SOLVE_KINDS:
        timed(kind, False)                         # warm-up, capture
        run, g, mg = timed(kind, False, spans=True)
        _, e, me = timed(kind, True)
        bitwise = all(torch.equal(getattr(g, f), getattr(e, f))
                      for f in ("x", "iters", "flag", "residual"))
        x_rel = float((g.x - e.x).abs().max() / e.x.abs().max())
        same = torch.equal(g.iters, e.iters) and torch.equal(g.flag, e.flag)
        ws = run.workspace
        row = dict(chains=DEEP_BETA_64X64.n_chains, Ltau=d.ops.Ltau, systems=g.iters.numel(),
                   iters=f"{g.iters.double().mean().item():.2f}", max_iters=int(g.iters.max()),
                   max_flag=int(g.flag.max()), bitwise=bitwise, x_rel=f"{x_rel:.3e}",
                   graphed_setup_s=f"{mg['setup_s']:.4f}", graphed_solve_s=f"{mg['solve_s']:.4f}",
                   eager_setup_s=f"{me['setup_s']:.4f}", eager_solve_s=f"{me['solve_s']:.4f}",
                   replays=mg["replays"], host_reads=mg["host_reads"],
                   replay_busy=f"{mg['busy']:.4f}", graphs=sorted(ws.graphs.graphs),
                   pool_mb=f"{ws.graphs.pool_bytes / 2**20:.1f}",
                   capture_s=f"{ws.graphs.capture_s:.3f}",
                   graphed_peak_gb=f"{mg['peak_gb']:.3f}", eager_peak_gb=f"{me['peak_gb']:.3f}")
        say(f"{DEEP_BETA_64X64.name}_graphed", kind=kind, **row)
        if (not (bitwise or (x_rel <= GRAPH_X_REL_TOL and same)) or row["max_flag"] != 0
                or mg["replays"] != mg["host_reads"] + 1 or mg["launches"] != me["launches"]):
            raise RuntimeError(f"graphed deep-beta {kind} solve left the eager one: {row}")
        out[kind] = row
        for f, n in mg["launches"].items():
            launches[f] = launches.get(f, 0) + n
        shapes |= mg["shapes"]
    out.update(table_launches=launches, launch_shapes=shapes)
    idle = [m for m in MODES["holstein"] if launches[m] <= 0]
    if idle:
        raise RuntimeError(f"graphed deep-beta solves: kernel forms launched no time {idle}")
    return out


def _deflated_memory() -> dict:
    """``AIDS_MEMORY_UPDATES`` graphed deflated 4×4 updates (4 chains, k 4,
    trajectory 0.1): allocated device memory after the 5th and after the
    last (no growth allowed), every flag 0."""
    from elphdynamics_tpu_torch.bench import build_bench_step

    b = build_bench_step(4, 1.0, 0.1, 0.05, 4, "cuda", torch.float32, trajectory_time=0.1,
                         deflate_k=4)
    state, mem, flag = b.state, {}, 0
    t0 = time.perf_counter()
    for n in range(1, AIDS_MEMORY_UPDATES + 1):
        state, stats = b.step(b.params, state, b.generator)
        flag = max(flag, int(stats.flag.max()))
        if n in (5, AIDS_MEMORY_UPDATES):
            torch.cuda.synchronize()
            mem[n] = torch.cuda.memory_allocated()
    out = dict(updates=AIDS_MEMORY_UPDATES,
               s_per_update=(time.perf_counter() - t0) / AIDS_MEMORY_UPDATES,
               allocated_after_5=mem[5], allocated_after_last=mem[AIDS_MEMORY_UPDATES],
               growth_bytes=mem[AIDS_MEMORY_UPDATES] - mem[5], max_flag=flag,
               segmented=b.step.segmented)
    say("graphed_deflated_memory", **out)
    if out["growth_bytes"] > 0 or flag != 0 or not b.step.segmented:
        raise RuntimeError(f"graphed deflated updates grew device memory or failed: {out}")
    return out


def phase_graphed_aids() -> dict:
    """42. The CG solver aids graphed, each against its eager form (after
    both kernels at the new shapes the aids give them, :func:`_kernel_shapes`):
    ``BLOCK_64X64``, ``DEFLATED_64X64``, ``NEARNULL_64X64`` (16 chains, K1
    and K2 inside the graphs) and ``LOWFREQ_32X32`` (32 chains, the dense Ā
    and its exact low-frequency blocks) updates; the 64×64 measurement
    with block probes; block CG on complex probes at ``TWISTED_64X64`` and
    ``SSH_TWISTED_64X64`` (phase 31's checks); the three
    ``DEEP_BETA_64X64`` solve kinds (phase 21's solves, both ways); and
    ``AIDS_MEMORY_UPDATES`` graphed deflated 4×4 updates with no memory
    growth (``chiprun_out/graphed_aids.json``). Returns the runs whose
    launches and shapes enter ``launches_by_path`` and phase 23: the
    Holstein paths (``holstein``), the twisted block calls (``twisted``)
    and the deep-β solves (``deep``)."""
    # the new shapes the aids give the kernels at 64×64 (Lτ = 40): the
    # deflation filter's and the near-null assembly's 16 × 32 rows, the
    # near-null smoothing's 16 × 16, the block probes' 4 × 10
    kernels = _kernel_shapes((("fold", (512,)), ("fold", (256,)), ("fold", (40,)),
                              ("fused", (16, 32)), ("fused", (16, 16)), ("fused", (4, 10))),
                             40, "aid_kernel")
    out = {"kernels": kernels, "updates": _aid_updates(),
           "block_measure_64x64": _block_measure_64(),
           "twisted": _twisted_block_probes(), "deep": _deep_beta_graphed(),
           "memory": _deflated_memory()}
    _write_json("graphed_aids.json", out)
    holstein = {f"graphed_{name}": res["parity"] for name, res in out["updates"].items()
                if name.endswith("64x64")}
    holstein["graphed_block_measure_64x64"] = out["block_measure_64x64"]["parity"]
    return {"holstein": holstein, "twisted": out["twisted"], "deep": out["deep"]}


# phase 43: BiCGStab and GMRES graphed
NONSYM_PROBES = 10            # nᵥ of the 64×64 GMRES measurement
NONSYM_MEASURE_CHAINS = 4
# the updates' trajectory in phase 43 (Nt = 10 of the configurations' 40:
# the script's time); phase_graphed_nonsym(cg_x, 1.0) runs them whole
NONSYM_TRAJECTORY = 0.25


def _nonsym_probe_solves(cg_x) -> dict:
    """Phase 13's GMRES and BiCGStab probe solves: nᵥ = 10 probes per chain
    of M·z = r on the ``LANGEVIN_64X64`` model (16 chains) with the left
    KPM apply, eager, on the probes phase 13 drew (seed 6): iterations,
    seconds, flags, launches, and the largest relative distance from CG's
    solution ``cg_x`` and from each other (≤ 1e-3)."""
    from elphdynamics_tpu_torch.bench import LANGEVIN_64X64, build
    from elphdynamics_tpu_torch.dynamics.solve import SolverConfig, resolve_precond, solve_minv
    from elphdynamics_tpu_torch.ops import ckb_cuda

    b = build(LANGEVIN_64X64, "cuda", torch.float32)
    ops, x = b.ops, b.x
    R = torch.randn((x.shape[0], NONSYM_PROBES, ops.Nsites, ops.Ltau), device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(6))
    ds = ops.stack(ops.derived(b.params, x))
    pa = resolve_precond(b.precond, b.params, x)
    kw = dict(tol=1e-5, maxiter=500)
    sols, out, shapes = {"cg": cg_x}, {}, set()
    for name, scfg in (("gmres", SolverConfig(kind="gmres", restart=20, **kw)),
                       ("bicgstab", SolverConfig(kind="bicgstab", **kw))):
        ckb_cuda.reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = solve_minv(ops, b.params, ds, R, scfg, pa)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        sols[name] = res.x
        shapes |= set(ckb_cuda.launch_shapes)
        out[name] = dict(iters=res.iters.double().mean().item(), max_iters=int(res.iters.max()),
                         seconds=secs, max_flag=int(res.flag.max()),
                         max_residual=res.residual.max().item(),
                         k1_launches=ckb_cuda.launches, k2_launches=ckb_cuda.fused_launches)
        say("solver_kinds_64x64", kind=name, systems=R.shape[0] * R.shape[1],
            **{k: (f"{v:.6g}" if isinstance(v, float) else v) for k, v in out[name].items()})

    def norm(a):
        return a.double().pow(2).sum(dim=(-2, -1)).sqrt()

    dist = max((norm(sols[a] - sols[c]) / norm(cg_x)).max().item()
               for a in sols for c in sols if a < c)
    say("solver_kinds_64x64", kinds=sorted(sols), max_mutual_distance=f"{dist:.3e}",
        tol=kw["tol"], gate=1e-3)
    bad = [k for k, v in out.items()
           if v["max_flag"] != 0 or v["k1_launches"] <= 0 or v["k2_launches"] <= 0]
    if bad or not dist <= 1e-3:
        raise RuntimeError(f"64x64 GMRES / BiCGStab probe solves: flagged or idle {bad}, "
                           f"distance {dist}")
    out["launch_shapes"] = shapes
    return out


def _bitwise_rows(name: str, rows: dict) -> None:
    """Phase 43 holds every call to its eager form bit for bit."""
    if not all(rows[u]["bitwise"] for u in (1, 2)):
        raise RuntimeError(f"graphed {name} is not bit for bit its eager form")


def _nonsym_update(cfg, trajectory_time: float) -> dict:
    """A nonsymmetric 64×64 update (its trajectory ``trajectory_time``)
    graphed against eager: parity (:func:`_graph_parity`, bit for bit),
    busy share, interleaved sweeps/s blocks; the eager updates' flags (a
    float32 tol² endpoint solve may flag: the graphed form must flag
    alike)."""
    b, eager, res = _graphed_update(cfg, MODES["holstein"], trajectory_time=trajectory_time)
    par = res["parity"]
    _bitwise_rows(cfg.name, par)
    ab = _sweeps_ab(b, eager, cfg.n_chains, b.state, GRAPH_AB_UPDATES)
    _say_ab(cfg.name, ab, "updates_per_block", GRAPH_AB_UPDATES, res["busy_graphed"])
    ws = b.step.workspace()
    acc = float(torch.cat(par["accepted"]).double().mean())
    res.update(ab=ab, acceptance=acc, max_flag=max(par[u]["max_flag"] for u in (1, 2)),
               graphs=sorted(ws.graphs.graphs), pool_bytes=ws.graphs.pool_bytes,
               capture_s=ws.graphs.capture_s)
    say(f"graphed_nonsym_{cfg.name}", Nt=b.hmc_cfg.Nt, acceptance=f"{acc:.4f}",
        max_flag=res["max_flag"],
        graphs=len(ws.graphs.graphs), pool_mb=f"{ws.graphs.pool_bytes / 2**20:.1f}",
        capture_s=f"{ws.graphs.capture_s:.3f}", retries=ws.retries)
    if not acc > 0:
        raise RuntimeError(f"{cfg.name}: acceptance {acc}")
    return res


def _nonsym_langevin(cfg) -> dict:
    """The GMRES Langevin step graphed against eager
    (:func:`_langevin_against_eager`, bit for bit) and interleaved
    chain-steps/s blocks."""
    from elphdynamics_tpu_torch.bench import build

    b = build(cfg, "cuda", torch.float32)
    eager = b.eager()
    res = _langevin_against_eager(cfg.name, b, eager, MODES["holstein"])
    _bitwise_rows(cfg.name, res["parity"])
    ab = _sweeps_ab(b, eager, cfg.n_chains, b.x, GRAPH_AB_UPDATES)
    _say_ab(cfg.name, ab, "steps_per_block", GRAPH_AB_UPDATES, res["busy_graphed"])
    ws = b.step.workspace()
    res.update(ab=ab, graphs=sorted(ws.graphs.graphs), pool_bytes=ws.graphs.pool_bytes,
               capture_s=ws.graphs.capture_s)
    say(f"graphed_nonsym_{cfg.name}", graphs=len(ws.graphs.graphs),
        pool_mb=f"{ws.graphs.pool_bytes / 2**20:.1f}", capture_s=f"{ws.graphs.capture_s:.3f}")
    return res


def _nonsym_measure_64() -> dict:
    """The 64×64 Holstein measurement (the stock file widened, 4 chains,
    nᵥ = 10) with GMRES probes (restart 20) on M with the left KPM apply,
    graphed against eager (:func:`_special_parity`: bit for bit, flags 0),
    seconds per call in interleaved blocks and the graphed call's busy
    share."""
    from elphdynamics_tpu_torch.bench import build_hmc_example, wide_hmc_config

    with open(os.path.join(_examples_dir(), "holstein_hmc_square.toml"), "rb") as f:
        cfg = wide_hmc_config(tomllib.load(f))
    cfg["solver"].update(type="GMRES", restart=20)
    cfg["measurements"]["num_random_vectors"] = NONSYM_PROBES
    ex = build_hmc_example(cfg, NONSYM_MEASURE_CHAINS, "cuda", torch.float32)
    twin = ex.eager()
    rows = _special_parity(ex, twin, "gmres_64x64", MODES["holstein"], parts=("measure",))
    x, g = ex.state.x, torch.Generator(device="cuda").manual_seed(23)
    R = twin.measure.draw(ex.params, x, g)
    ab = _calls_ab(lambda: ex.measure(ex.params, x, R=R), lambda: twin.measure(ex.params, x, R=R))
    torch.cuda.synchronize()
    with counting_replays(timed=True) as box:
        t0 = time.perf_counter()
        ex.measure(ex.params, x, R=R)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy = sum(a.elapsed_time(c) for a, c in box["spans"]) / 1e3 / wall
    ws = ex.measure.workspace()
    say("graph_ab_gmres_measure_64x64", chains=NONSYM_MEASURE_CHAINS, nv=NONSYM_PROBES,
        eager_median_s=f"{ab['eager']['median']:.4f}", eager_iqr=f"{ab['eager']['iqr']:.4f}",
        graphed_median_s=f"{ab['graphed']['median']:.4f}",
        graphed_iqr=f"{ab['graphed']['iqr']:.4f}", speedup_median=f"{ab['speedup_median']:.3f}",
        graphed_replay_busy=f"{busy:.4f}", pool_mb=f"{ws.graphs.pool_bytes / 2**20:.1f}",
        capture_s=f"{ws.graphs.capture_s:.3f}", graphs=len(ws.graphs.graphs))
    if "gmres" not in ws or ws.gmres.x.shape[1] != NONSYM_PROBES:
        raise RuntimeError("the 64x64 GMRES measurement did not solve by GMRES")
    return dict(parity=rows["measure"], ab=ab, busy=busy, pool_bytes=ws.graphs.pool_bytes,
                capture_s=ws.graphs.capture_s)


def phase_graphed_nonsym(cg_x, trajectory_time: float = NONSYM_TRAJECTORY) -> dict:
    """43. BiCGStab and GMRES graphed (``dynamics/graphs.NonsymSolve``),
    each against its eager form on the same draws, bit for bit, replays =
    host reads + 1, equal K1 / K2 launches by form, flags as in the eager
    form: the ``GMRES_64X64`` and ``BICGSTAB_64X64`` updates (each (MᵀM)⁻¹
    two solves, Mᵀ with the right KPM apply, then M with the left one; the
    trajectory cut to ``trajectory_time``, the tol² endpoint solves whole) and
    the ``GMRES_LANGEVIN_64X64`` step (16 chains, RK), with busy shares and
    interleaved sweeps/s (chain-steps/s) blocks; the 64×64 measurement (4
    chains, nᵥ = 10) with GMRES probes; phase 22's GMRES and BiCGStab probe
    solves, held to CG's solution ``cg_x`` (``chiprun_out/graphed_nonsym.json``).
    Returns the runs whose launches and shapes enter ``launches_by_path``
    and phase 23."""
    from elphdynamics_tpu_torch.bench import (
        BICGSTAB_64X64, GMRES_64X64, GMRES_LANGEVIN_64X64)

    out = {"probes": _nonsym_probe_solves(cg_x)}
    for cfg in (GMRES_64X64, BICGSTAB_64X64):
        out[cfg.name] = _nonsym_update(cfg, trajectory_time)
        gc.collect()
        torch.cuda.empty_cache()
    out[GMRES_LANGEVIN_64X64.name] = _nonsym_langevin(GMRES_LANGEVIN_64X64)
    out["gmres_measure_64x64"] = _nonsym_measure_64()
    _write_json("graphed_nonsym.json", out)
    runs = {f"graphed_{name}": out[name]["parity"]
            for name in (GMRES_64X64.name, BICGSTAB_64X64.name, GMRES_LANGEVIN_64X64.name,
                         "gmres_measure_64x64")}
    return {"runs": runs, "probe_shapes": out["probes"]["launch_shapes"]}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import elphdynamics_tpu_torch  # noqa: F401  (fails outside a checkout)

    phase_card()
    phase_build()
    kern = phase_kernel_vs_twin()
    fused = phase_fused_vs_twin()
    tables = phase_table_kernels()
    ctables = phase_complex_kernels()
    phase_small_reference()
    phase_small_ssh_reference()
    phase_small_fused_reference()
    phase_small_langevin_reference()
    phase_small_solver_reference()
    phase_small_twisted_reference()
    phase_small_deep_reference()
    phase_loop_precision()

    from elphdynamics_tpu_torch.bench import (
        BENCH_8X8, KERNEL_64X64, LANGEVIN_64X64, SSH_64X64, SSH_LANGEVIN_64X64,
        SSH_TWISTED_64X64, TWISTED_64X64)

    run_config(BENCH_8X8, warmup=1, timed=2)
    shapes, runs = {}, {}
    holstein = ("fold/shared", "fused/shared")
    # the twisted 64×64 updates: phase 40 (phase 17's runs folded into it);
    # the 2MN and tempering 64×64 runs (phase 20's): phase 41
    for cfg, forms, timed in ((KERNEL_64X64, holstein, 2),
                              (SSH_64X64, ("fold/column", "fold/chain", "fused/chain"), 2)):
        big = runs[cfg.name] = run_config(cfg, warmup=1, timed=timed)
        shapes[cfg.name] = big["launch_shapes"]
        idle = [f for f in forms if big["table_launches"][f] <= 0]
        if idle:
            raise RuntimeError(f"{cfg.name}: kernel modes launched no time: {idle}")
        if big["max_flag"] != 0 or big["acceptance"] <= 0:
            raise RuntimeError(f"{cfg.name}: flag {big['max_flag']}, "
                               f"acceptance {big['acceptance']}")
    graphed_upd = phase_graphed_update()
    phase_graphed_update_ssh()
    graphed_lang = phase_graphed_langevin()
    graphed_special = phase_graphed_special_measure()
    graphed_cplx = phase_graphed_complex()
    graphed_chains = phase_graphed_chains(kernel_ref=graphed_upd[KERNEL_64X64.name])
    aids = phase_graphed_aids()
    phase_chebyshev_ab()
    lang = run_langevin_config(LANGEVIN_64X64, warmup=1, timed=3)
    lang_ssh = run_langevin_config(SSH_LANGEVIN_64X64, warmup=1, timed=3)
    kinds = phase_solver_kinds_64()
    shapes["solver_kinds_64x64"] = kinds["launch_shapes"]
    nonsym = phase_graphed_nonsym(kinds.pop("cg_x"))
    shapes["solver_kinds_nonsym_64x64"] = nonsym["probe_shapes"]
    phase_graphed_sites_one_card()
    block_cplx, deep = aids["twisted"], aids["deep"]
    phase_deep_beta_kernels()
    # the stock 4×4 examples are host-bound (dense branch, 100 leapfrog steps
    # per update, 4–6 s each; SSH's KPM at max_order 64, 25–45 s each): a few
    # updates each; the 64×64 runs (SSH's at ~19 s per update) and the SSH
    # 4×4 run take one sampling update and no burn-in. The 64×64 Holstein
    # run adds one burn-in update: from the fresh start H drifts by 0.45–0.72
    # over the first trajectory on every chain, which 18 of 28 chains
    # accepted, so all four reject it about one run in 60; 15 of 16 accepted
    # the second (scripts/driver_acceptance_probe.py)
    drv = phase_driver("holstein_hmc_square", "holstein", (1, 2, 2), big_updates=(1, 1, 1))
    drv_ssh = phase_driver("ssh_hmc_square", "ssh", (0, 1, 1), big_updates=(0, 1, 1))
    drv_lang = phase_driver_langevin()
    drv_tw = phase_driver_twisted()
    phase_driver_deep()
    shapes["seed_draws_64x64"] = phase_seed_draws()
    shapes["float32_energy_64x64"] = phase_float32_energy()
    phase_ed_float32()
    chains = phase_chain_sharded(runs[KERNEL_64X64.name])
    h2_ref = h2_references()
    h2 = phase_h2(h2_ref)
    nccl = phase_nccl(runs[KERNEL_64X64.name], h2_ref)
    idle = [f for f in ("fold/column", "fold/chain", "fused/chain")
            if drv_ssh["table_launches"][f] <= 0]
    if idle:
        raise RuntimeError(f"the 64x64 SSH driver run launched these kernel modes no time: {idle}")
    if not all(math.isfinite(k["ms"]) for k in (kern, fused, *tables.values(), *ctables.values())):
        raise RuntimeError("kernel timing missing")
    holstein_paths = {KERNEL_64X64.name: runs[KERNEL_64X64.name],
                      "hmc_driver_64x64": drv, "langevin_driver_64x64": drv_lang,
                      LANGEVIN_64X64.name: lang, "deep_beta_64x64": deep,
                      "chain_sharded_64x64": chains}
    ssh_paths = {"ssh_hmc_driver_64x64": drv_ssh, SSH_LANGEVIN_64X64.name: lang_ssh}
    # phase 38's second graphed steps, phase 39's, phase 41's, phase 42's
    # and phase 43's second graphed calls: the kernels inside the Langevin,
    # move, measurement, 2MN, laddered update and exchange graphs (41: on
    # chain ranks too), those of the solver aids (block CG, deflation,
    # near-null) and those of BiCGStab and GMRES
    for k, r in (graphed_lang | graphed_special | graphed_chains | aids["holstein"]
                 | nonsym["runs"]).items():
        (ssh_paths if "ssh" in k else holstein_paths)[k] = r
    # slice H2's paths that reach the kernels: tempering on chain ranks (each
    # rank's own counts) and the chain blocks' measurements of the 2x2 layout
    for tag, paths in (("", h2), ("_nccl", (nccl or {}).get("h2", {}))):
        for k, r in paths.items():
            (ssh_paths if k.startswith("ssh_") else holstein_paths)[k + tag] = r
    if nccl is not None:
        holstein_paths["chain_sharded_64x64_nccl"] = nccl["chain_sharded"]
    # K1's complex mode: the stock twisted SSH example (its fermion operator
    # and densified Ā are K1's at any size; the 4×4 Holstein example runs
    # dense matmuls), phase 42's graphed block-CG probe solves of both
    # twisted 64×64 models and (below) phase 40's graphed twisted calls
    twisted_paths = {f"block_cg_{TWISTED_64X64.name}":
                     block_cplx[f"block_cg_{TWISTED_64X64.name}"]}
    twisted_ssh_paths = {"ssh_twisted_driver_4x4": drv_tw["ssh_hmc_twisted"],
                         f"block_cg_{SSH_TWISTED_64X64.name}":
                             block_cplx[f"block_cg_{SSH_TWISTED_64X64.name}"]}
    # phase 40's second graphed calls: K1's complex mode inside the graphs
    # (path_shapes takes the 64×64 runs' shapes)
    for k, r in graphed_cplx.items():
        (twisted_ssh_paths if "ssh" in k else twisted_paths)[k] = r
        if k.endswith("64x64"):
            shapes[k] = r["launch_shapes"]
    shapes.update({k: r["launch_shapes"] for k, r in (holstein_paths | ssh_paths).items()})
    shapes.update({k: r["launch_shapes"] for k, r in block_cplx.items()})
    phase_path_shapes(shapes)
    say("total", seconds=f"{time.perf_counter() - T_START:.1f}")

    def entry(name, mode, source, replaces, k, paths):
        """One kernel mode's line: its launches in each run of ``paths``
        (every one must have launched it) and their sum."""
        by_path = {p: r["table_launches"][mode] for p, r in paths.items()}
        if min(by_path.values()) <= 0:
            raise RuntimeError(f"{name}: a run launched it no time: {by_path}")
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": sum(by_path.values()), "launches_by_path": by_path,
                "max_abs_err": k["max_abs_err"], "ms": k["ms"],
                "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
                "bound_share": k["bound_ms"] / k["ms"], "library_ms": k["library_ms"]}

    k1 = ("elphdynamics_tpu_torch/csrc/ckb_fold.cu", "elphdynamics_tpu/ops/ckb_pallas.py:75")
    k2 = ("elphdynamics_tpu_torch/csrc/ckb_fold_fused.cu",
          "elphdynamics_tpu/ops/ckb_pallas.py:128")
    print(json.dumps({"kernels": [
        entry("ckb_fold", "fold/shared", *k1, kern, holstein_paths),
        entry("ckb_fold[per-chain-bond-column tables]", "fold/column", *k1,
              tables["fold/column"], ssh_paths),
        entry("ckb_fold[per-chain tables]", "fold/chain", *k1, tables["fold/chain"], ssh_paths),
        entry("ckb_fold_fused", "fused/shared", *k2, fused, holstein_paths),
        entry("ckb_fold_fused[per-chain tables]", "fused/chain", *k2, tables["fused/chain"],
              ssh_paths),
        entry("ckb_fold[complex]", "fold/shared/complex", *k1,
              ctables["fold/shared/complex"], twisted_paths),
        entry("ckb_fold[complex, per-chain-bond-column tables]", "fold/column/complex", *k1,
              ctables["fold/column/complex"], twisted_ssh_paths),
        entry("ckb_fold[complex, per-chain tables]", "fold/chain/complex", *k1,
              ctables["fold/chain/complex"], twisted_ssh_paths),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

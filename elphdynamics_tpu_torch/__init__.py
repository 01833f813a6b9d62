"""elphdynamics_tpu_torch — the PyTorch/CUDA port of ``elphdynamics_tpu``.

The port keeps the JAX package's module and function names so each
counterpart is easy to find, but follows PyTorch idiom inside:

* plain functions on tensors; frozen dataclasses with tensor fields for
  specs, parameters and solver state;
* an explicit ``device`` and ``dtype`` everywhere (there is no global x64
  switch; float64 on the CPU is the parity mode, float32 on the GPU the
  production mode);
* explicit ``torch.Generator`` objects, and an optional ``draws`` argument
  wherever a function draws random numbers, so that tests can feed the
  JAX package's draws in;
* the chain axis is an explicit leading dimension instead of ``jax.vmap``.

The hand-written CUDA kernels, the checkerboard fold (``csrc/ckb_fold.cu``)
and the fused Chebyshev step (``csrc/ckb_fold_fused.cu``), are built by
``nvcc`` at first use (:mod:`elphdynamics_tpu_torch.ops.ckb_cuda`).

The user entry point is the TOML driver,
``python -m elphdynamics_tpu_torch input.toml [run_id]``
(:mod:`elphdynamics_tpu_torch.simulation`).

This package never imports ``jax`` nor ``elphdynamics_tpu``.
"""

__version__ = "0.1.0"

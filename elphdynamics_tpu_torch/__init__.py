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

The hand-written CUDA kernel of the checkerboard fold lives in
``csrc/ckb_fold.cu`` and is built by ``nvcc`` at first use
(:mod:`elphdynamics_tpu_torch.ops.ckb_cuda`).

This package never imports ``jax`` nor ``elphdynamics_tpu``.
"""

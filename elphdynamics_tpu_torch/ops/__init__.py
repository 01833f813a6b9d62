"""Operators: checkerboard fold (plain torch and CUDA kernel), τ↔ω
transforms, Fourier acceleration and the KPM preconditioner."""

"""Measurements: stochastic Green's functions, observables and bins, and
the chemical-potential tuner."""

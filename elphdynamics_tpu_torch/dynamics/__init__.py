"""Samplers: linear-solve dispatch, initial phonons, HMC."""

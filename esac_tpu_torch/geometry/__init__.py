"""Batched pinhole geometry, rotations, quartic roots and minimal PnP.

Every function takes leading batch dimensions where the JAX package
``vmap``s: B x M x n_hyps minimal solves are one tensor computation.
"""

"""Masked cross-sectional ops, batched Jacobi eigh (with its Hopper kernels)
and the constrained cross-sectional WLS regression."""

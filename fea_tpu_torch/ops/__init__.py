"""Operators and preconditioners: the structured stencil, its CUDA
kernels, and geometric multigrid."""

"""Kernels and plain ops of the port, channels-last like the JAX package."""

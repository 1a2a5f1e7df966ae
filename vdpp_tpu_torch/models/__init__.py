"""Denoisers: the SVD UNet and its Euler/CFG wrapper."""

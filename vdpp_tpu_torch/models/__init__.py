"""Denoisers: the SVD UNet and its wrapper, the video DiT, the simulator's
DummyUNet; the encoders and the VAE."""

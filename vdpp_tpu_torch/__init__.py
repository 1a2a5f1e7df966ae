"""vdpp_tpu_torch: the PyTorch + CUDA port of ``vdpp_tpu`` for NVIDIA Hopper.

Step-pipelined SVD image->video denoising, ported slice by slice from the JAX
package, which stays beside it as the reference. Public layouts follow the
JAX package (channels-last ``(B, F, H, W, C)`` latents, ``(B, L, H, D)``
attention), modules carry diffusers parameter names, and every TPU kernel on
a ported path is a CUDA kernel under ``csrc/`` with a plain PyTorch twin.

Entry points run on a CUDA device unless the caller passes ``device="cpu"``.
This package imports neither ``jax`` nor ``vdpp_tpu``.
"""

__version__ = "0.1.0"

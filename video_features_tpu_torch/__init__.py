"""PyTorch/CUDA port of ``video_features_tpu``.

The JAX package stays the reference; this package imports nothing of it
and nothing of JAX. Modules keep the JAX package's names. Plain tensor
code is PyTorch; each TPU (Pallas) kernel of a ported path is a CUDA
kernel written for Hopper under ``csrc/``, built at first use
(``ops/kernels.py``).
"""

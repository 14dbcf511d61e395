"""PyTorch/CUDA port of the EEE link power-saving simulator.

Mirrors the layout of the JAX package ``repro`` module for module; its
decoupled fast path runs on hand-written CUDA kernels for Hopper
(``repro_torch.kernels``).  Entry points take ``device=None``, which means
``"cuda"``; pass ``device="cpu"`` to run the plain PyTorch versions on the
host.
"""

"""PyTorch/CUDA port of the LTP reproduction.

Mirrors the JAX package ``repro`` module for module, imports nothing of
it, and runs its entry points on ``cuda`` unless the caller passes
``device="cpu"``. The PS hot loop and the Random-k select run through
hand-written Hopper kernels (``repro_torch.kernels``).
"""

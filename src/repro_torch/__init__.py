"""PMV on PyTorch: pre-partitioned GIM-V with hand-written Hopper kernels.

The port of the JAX package ``repro`` to PyTorch and CUDA.  It imports
``torch``, numpy and scipy only, and keeps its own copies of whatever host
code it shares with the JAX package.  Entry point: ``repro_torch.core.PMVEngine``.
"""

"""PMV on PyTorch: pre-partitioned GIM-V with hand-written Hopper kernels.

The port of the JAX package ``repro`` to PyTorch and CUDA.  It imports
``torch``, numpy and scipy only, and keeps its own copies of whatever host
code it shares with the JAX package.  Entry point: ``repro_torch.core.PMVEngine``.

The JAX package's LM scaffolding (no PMV code, no Pallas kernel) is ported
up to its serving path: ``repro_torch.configs``, ``repro_torch.models`` and
``repro_torch.launch`` (``flops``, ``serve``: ``python -m
repro_torch.launch.serve --arch qwen3_1_7b``).

Not ported yet: the LM training slice: ``repro_torch.training``,
``repro_torch.launch.train``, ``repro_torch.launch.dryrun``,
``repro_torch.launch.hlo_analysis``, ``repro_torch.launch.roofline``,
``repro_torch.launch.mesh`` and ``repro_torch.models.sharding``.
"""

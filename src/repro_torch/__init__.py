"""PMV on PyTorch: pre-partitioned GIM-V with hand-written Hopper kernels.

The port of the JAX package ``repro`` to PyTorch and CUDA.  It imports
``torch``, numpy and scipy only, and keeps its own copies of whatever host
code it shares with the JAX package.  Entry point: ``repro_torch.core.PMVEngine``.

The JAX package's LM scaffolding (no PMV code, no Pallas kernel) is ported
on one device: ``repro_torch.configs``, ``repro_torch.models``,
``repro_torch.training`` and ``repro_torch.launch`` (``flops``, ``serve``,
``train``: ``python -m repro_torch.launch.serve --arch qwen3_1_7b``,
``python -m repro_torch.launch.train --arch qwen3_1_7b``).

Not ported yet: the multi-device LM slice (``repro_torch.models.sharding``,
``repro_torch.launch.mesh``, ``repro_torch.training.pipeline``), and
``repro_torch.launch.dryrun``, ``repro_torch.launch.hlo_analysis`` and
``repro_torch.launch.roofline``.
"""

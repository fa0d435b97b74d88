"""PMV on PyTorch: pre-partitioned GIM-V with hand-written Hopper kernels.

The port of the JAX package ``repro`` to PyTorch and CUDA.  It imports
``torch``, numpy and scipy only, and keeps its own copies of whatever host
code it shares with the JAX package.  Entry point: ``repro_torch.core.PMVEngine``.

The JAX package's LM scaffolding (no PMV code, no Pallas kernel) is ported
whole: ``repro_torch.configs``, ``repro_torch.models``,
``repro_torch.training`` and ``repro_torch.launch`` (``flops``, ``serve``,
``train``: ``python -m repro_torch.launch.serve --arch qwen3_1_7b``,
``python -m repro_torch.launch.train --arch qwen3_1_7b``), and its
multi-device slice on a torch ``DeviceMesh``: ``repro_torch.models.sharding``
(the parameter / batch / cache rules as DTensor placements, run in the FSDP
idiom of ``repro_torch.models.spmd``, ``cfg.seq_parallel`` included),
``repro_torch.launch.mesh``, ``repro_torch.training.pipeline`` (GPipe over
the pod axis), ``TrainConfig(compress_pod=True)``, checkpoints that re-shard
across meshes, and ``python -m repro_torch.launch.dryrun`` (a fake 256 / 512
rank process group) with ``repro_torch.launch.hlo_analysis`` and
``repro_torch.launch.roofline`` (H100 data-sheet constants).  Every module
of the JAX package has its counterpart here.
"""

"""Launchers of the LM scaffolding, ported from the JAX package's
``repro.launch``: ``flops`` (the analytic parameter / FLOP / byte model),
``serve`` (greedy prefill and decode against the caches) and ``train``
(the training launcher with checkpoint / restart).  Not ported yet:
``dryrun``, ``hlo_analysis``, ``roofline`` and ``mesh``."""

"""Launchers of the LM scaffolding, ported from the JAX package's
``repro.launch``: ``flops`` (the analytic parameter / FLOP / byte model) and
``serve`` (greedy prefill and decode against the caches).  Not ported yet:
``train``, ``dryrun``, ``hlo_analysis``, ``roofline`` and ``mesh``."""

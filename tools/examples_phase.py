"""The smoke's examples phase alone, on one CUDA card: the eight
``examples/*_torch.py`` through ``chip_smoke.examples_phase`` (each held to
its JAX-free oracle), after a probe of whether ``scatter_reduce_``'s sum is
bitwise from call to call on the card with and without
``torch.use_deterministic_algorithms`` (the chaos and fleet examples' solves
must agree bitwise), beside the mesh phase's dry run of
``qwen3_1_7b@train_4k`` in a subprocess (its counts and trace seconds).

    python3 tools/examples_phase.py [--examples chaos_run fleet_trace ...]

Runs from the repository root; exits 1 when an example fails its oracle or
the dry run's counts differ from the whole trace's.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--examples", nargs="+", default=list(smoke.EXAMPLES),
                    choices=smoke.EXAMPLES)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        return smoke.refuse("no CUDA device is available")
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import scipy.sparse as sp
    from scipy.sparse import csgraph

    from repro_torch.kernels.build import build_all

    t0 = time.perf_counter()
    smoke.log(f"card: {smoke.card_line()}")
    d = tempfile.mkdtemp(prefix="examples_dryrun_")
    dry = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", smoke.LM_ARCH, "--shape",
         "train_4k", "--mesh", "single", "--force", "--results-dir", d], cwd=str(ROOT),
        env={**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"},
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        build_all()
        smoke.log(f"build: {time.perf_counter() - t0:.1f} s")
        gen = torch.Generator(device="cuda")
        gen.manual_seed(0)
        idx = torch.randint(0, 1000, (2_000_000,), generator=gen, device="cuda")
        x = torch.rand(2_000_000, generator=gen, device="cuda")
        for det in (False, True):
            torch.use_deterministic_algorithms(det, warn_only=True)
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                a, b = (torch.zeros(1000, device="cuda").scatter_reduce_(
                    0, idx, x, reduce="sum", include_self=True) for _ in range(2))
            smoke.log(f"probe scatter_reduce_ sum of 2M values into 1000 slots, twice, "
                      f"deterministic={det}: bitwise {bool(torch.equal(a, b))}; warnings "
                      f"{[str(w.message)[:80] for w in caught]}")
        torch.use_deterministic_algorithms(False)
        smoke.EXAMPLES = tuple(args.examples)
        rows, failures = {}, []
        smoke.examples_phase(torch, np, sp, csgraph, rows, failures)
        out = dry.communicate(timeout=900)[0]
        rec = json.load(open(os.path.join(d, f"single__lm__{smoke.LM_ARCH}@train_4k.json")))
        flops, nbytes = rec["cost"]["flops"], rec["collectives"]["bytes"]["total"]
        same = (flops, nbytes) == (smoke.MESH_DRYRUN_FLOPS, smoke.MESH_DRYRUN_BYTES)
        smoke.log(f"dryrun: {out.strip().splitlines()[-1]}; flops {flops!r} bytes {nbytes!r} "
                  f"(whole trace's: {same}); trace {rec['lower_s']} s, fit "
                  f"{json.dumps(rec['meta']['fit'])}, device_type {rec['meta']['device_type']}")
        if not same:
            failures.append("the mesh dry run's counts moved")
        smoke.log(f"launches {json.dumps(rows)}; failures {failures}; "
                  f"{time.perf_counter() - t0:.1f} s in all")
        return 1 if failures else 0
    finally:
        if dry.poll() is None:
            dry.kill()
            dry.wait()
        shutil.rmtree(d, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())

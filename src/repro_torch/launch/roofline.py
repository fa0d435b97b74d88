"""Roofline table generation from the port's dry-run records + the analytic
cost model (the JAX package's ``repro.launch.roofline``, for H100 GPUs).

Terms per (cell, mesh), all in seconds-per-step:

    compute    = FLOPs_global        / (GPUs x 989e12 bf16 FLOP/s)
    memory     = HBM_bytes_global    / (GPUs x 3.35e12 B/s)
    collective = wire_bytes_per_GPU  / (450e9 B/s, NVLink 4, one direction)

The constants are the H100 SXM data sheet's (dense bf16 tensor-core peak,
HBM3 bandwidth, NVLink 4's 900 GB/s per GPU counted as 450 GB/s each
way); none of them is measured, and none is a TPU's.  FLOPs / HBM come
from the analytic model (``launch.flops``), collective bytes from the dry
run's recorded collectives (``launch.hlo_analysis``).  A mesh of more than
8 GPUs crosses nodes, whose network is slower than NVLink: such a cell is
flagged (``crosses_nodes``), as the JAX package flags the pod axis, and its
collective term is optimistic.  The records are of the port's step:
tensor parallel over 'model' for the layers whose heads / columns divide
it, the others' weights gathered over 'model', FSDP over 'data' (each
row's ``parallelism``, from the record's meta, and the table's header say
which layers).

MODEL_FLOPS = 6·N_active·D for train, 2·N_active·D for inference; the ratio
MODEL_FLOPS/FLOPs flags remat/masking/padding waste.
"""
from __future__ import annotations

import dataclasses
import glob
import json
import os

import numpy as np

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..", "build",
                           "dryrun_results")


@dataclasses.dataclass(frozen=True)
class GpuSpec:
    """Data-sheet peaks of one GPU."""

    name: str
    peak_flops_bf16: float      # dense bf16 tensor-core FLOP/s
    hbm_bw: float               # B/s
    nvlink_bw: float            # B/s per GPU, one direction
    gpus_per_node: int          # NVLink domain


H100 = GpuSpec(name="H100 SXM (data sheet)", peak_flops_bf16=989e12, hbm_bw=3.35e12,
               nvlink_bw=450e9, gpus_per_node=8)

# PMV per-edge cost: combine2 (1 mul) + combineAll (1 add/min) per edge.
PMV_EDGE_FLOPS = 2.0
PMV_EDGE_BYTES = 12.0   # seg,gat int32 + w f32 read per edge


def load_cells(mesh: str | None = None, *, results_dir: str = RESULTS_DIR):
    """The dry run's records (``repro_torch.launch.dryrun``), one mesh's or
    all.  The port keeps no HLO, so there is nothing to re-analyse: the
    recorded collectives are the totals."""
    rows = []
    for f in sorted(glob.glob(os.path.join(results_dir, "*.json"))):
        with open(f) as fh:
            r = json.load(fh)
        if mesh and r["mesh"] != mesh:
            continue
        rows.append(r)
    return rows


def _chips(rec) -> int:
    return int(np.prod(list(rec["mesh_shape"].values())))


def roofline_row(rec, gpu: GpuSpec = H100) -> dict | None:
    if not rec.get("ok"):
        return None
    chips = _chips(rec)
    coll_bytes_per_chip = rec["collectives"]["bytes"]["total"]
    t_coll = coll_bytes_per_chip / gpu.nvlink_bw

    if rec["kind"] == "lm":
        ana = rec.get("analytic") or {}
        flops, hbm = ana.get("flops", 0), ana.get("hbm_bytes", 0)
        model_flops = ana.get("model_flops", 0)
    else:
        meta = rec.get("meta", {})
        m = meta.get("m", 0)
        n = meta.get("n", 0)
        flops = m * PMV_EDGE_FLOPS
        hbm = m * PMV_EDGE_BYTES + 3 * n * 4
        model_flops = flops

    t_comp = flops / (chips * gpu.peak_flops_bf16)
    t_mem = hbm / (chips * gpu.hbm_bw)
    terms = {"compute": t_comp, "memory": t_mem, "collective": t_coll}
    dominant = max(terms, key=terms.get)
    total = max(terms.values())
    useful_frac = (model_flops / (chips * gpu.peak_flops_bf16)) / total if total > 0 else 0.0
    return {
        "cell": rec["cell"], "mesh": rec["mesh"], "chips": chips, "kind": rec["kind"],
        "t_compute_s": t_comp, "t_memory_s": t_mem, "t_collective_s": t_coll,
        "dominant": dominant,
        "flops": flops, "model_flops": model_flops,
        "useful_ratio": model_flops / flops if flops else 0.0,
        "roofline_frac": useful_frac,   # model-flops-time / bottleneck-time
        "coll_bytes_per_chip": coll_bytes_per_chip,
        "arg_bytes_per_chip": rec["memory"].get("argument_bytes", 0),
        "crosses_nodes": chips > gpu.gpus_per_node,
        "parallelism": rec.get("meta", {}).get("parallelism", "not recorded"),
    }


def table(mesh="single", *, results_dir: str = RESULTS_DIR) -> list[dict]:
    rows = [roofline_row(r) for r in load_cells(mesh, results_dir=results_dir)]
    return [r for r in rows if r]


def markdown(mesh="single", *, results_dir: str = RESULTS_DIR) -> str:
    rows = table(mesh, results_dir=results_dir)
    kinds = sorted({r["parallelism"] for r in rows})
    hdr = "".join(f"Parallelism traced: {p}.\n" for p in kinds) + "\n" + ("| cell | GPUs | compute (ms) | memory (ms) | collective (ms) | dominant "
           "| MODEL/analytic flops | roofline frac | resident GiB/GPU | crosses nodes |\n"
           "|---|---|---|---|---|---|---|---|---|---|\n")
    lines = []
    for r in sorted(rows, key=lambda x: (x["kind"], x["cell"])):
        lines.append(
            f"| {r['cell']} | {r['chips']} | {r['t_compute_s']*1e3:.2f} | "
            f"{r['t_memory_s']*1e3:.2f} | {r['t_collective_s']*1e3:.3f} | {r['dominant']} | "
            f"{r['useful_ratio']:.2f} | {r['roofline_frac']:.2%} | "
            f"{r['arg_bytes_per_chip']/2**30:.2f} | {'yes' if r['crosses_nodes'] else 'no'} |")
    return hdr + "\n".join(lines) + "\n"


if __name__ == "__main__":
    import sys
    print(markdown(sys.argv[1] if len(sys.argv) > 1 else "single"))

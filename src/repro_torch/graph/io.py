"""Edge-list I/O: tsv (paper's input format) and npy (fast path); numpy
only, this package's own copy of the JAX package's ``repro.graph.io``.

``load_edges`` slurps the whole list (fine for in-memory partitioning);
``iter_edges`` streams it in bounded chunks — the input side of the
out-of-core pre-partitioned store (repro_torch.store.ingest), which never holds
more than ``chunk_edges`` rows of the source at once.
"""
from __future__ import annotations

import gzip
import os
from typing import Iterator

import numpy as np

__all__ = ["load_edges", "save_edges", "infer_n", "iter_edges"]

DEFAULT_CHUNK_EDGES = 1 << 20


def _check_ids(edges: np.ndarray, where: str) -> np.ndarray:
    """Vertex ids must be non-negative: a negative id silently wraps through
    ``id % b`` / ``id // b`` into a *valid-looking* block slot, producing
    bogus stripes instead of an error."""
    if edges.size and int(edges.min()) < 0:
        bad = edges[(edges < 0).any(axis=1)][0]
        raise ValueError(
            f"negative vertex id in {where}: edge {tuple(int(x) for x in bad)} "
            "— vertex ids must be >= 0")
    return edges


def load_edges(path: str) -> np.ndarray:
    if path.endswith(".npy"):
        edges = np.load(path)
    elif path.endswith(".gz"):
        with gzip.open(path, "rt") as f:
            edges = np.loadtxt(f, dtype=np.int64, comments="#")
    else:
        edges = np.loadtxt(path, dtype=np.int64, comments="#")
    edges = np.asarray(edges, dtype=np.int64)
    if edges.ndim == 2 and edges.shape[1] > 2:
        # 'src dst weight ...' rows: keep the id columns (iter_edges does the
        # same) instead of reshape-garbling weights into fake vertex ids
        edges = edges[:, :2]
    edges = edges.reshape(-1, 2)
    return _check_ids(edges, path)


def save_edges(path: str, edges: np.ndarray) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    if path.endswith(".npy"):
        np.save(path, np.asarray(edges, dtype=np.int64))
    else:
        edges = np.asarray(edges, dtype=np.int64)
        if path.endswith(".gz"):
            with gzip.open(path, "wt") as f:
                np.savetxt(f, edges, fmt="%d", delimiter="\t")
        else:
            np.savetxt(path, edges, fmt="%d", delimiter="\t")


def infer_n(edges: np.ndarray) -> int:
    edges = np.asarray(edges)
    _check_ids(edges, "infer_n input")
    return int(edges.max()) + 1 if edges.size else 0


def iter_edges(path: str, chunk_edges: int = DEFAULT_CHUNK_EDGES) -> Iterator[np.ndarray]:
    """Stream an edge list in chunks of at most ``chunk_edges`` [k, 2] int64
    rows.  Supports .npy (memmap-backed — no full read), .tsv/.txt, and
    gzip-compressed text (.tsv.gz etc.).  Ids are validated per chunk."""
    assert chunk_edges > 0, chunk_edges
    if path.endswith(".npy"):
        mm = np.load(path, mmap_mode="r")
        if mm.ndim == 2 and mm.shape[1] > 2:
            mm = mm[:, :2]  # 'src dst weight ...' rows: keep the id columns
        else:
            mm = mm.reshape(-1, 2)
        for lo in range(0, mm.shape[0], chunk_edges):
            chunk = np.asarray(mm[lo: lo + chunk_edges], dtype=np.int64)
            yield _check_ids(chunk, path)
        return
    opener = (lambda: gzip.open(path, "rt")) if path.endswith(".gz") else (lambda: open(path))
    with opener() as f:
        rows: list[tuple[int, int]] = []
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            s, d = line.split()[:2]
            rows.append((int(s), int(d)))
            if len(rows) >= chunk_edges:
                yield _check_ids(np.asarray(rows, dtype=np.int64), path)
                rows = []
        if rows:
            yield _check_ids(np.asarray(rows, dtype=np.int64), path)

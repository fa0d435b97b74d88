"""Streaming ingester: edge stream -> on-disk pre-partitioned block store
(this package's counterpart of the JAX package's ``repro.store.ingest``;
both write the same bytes for the same edges and arguments).

``partition_graph`` holds the whole edge list plus every b x b block in host
memory — exactly what PMV's headline capacity claim (§1: 16x larger graphs
than memory-based systems) says we must not require.  This module replays
the paper's one-off pre-partitioning as external binning over a bounded
edge stream (GraphD / PCPM's recipe: partition once to disk, then pay only
sequential partition-granular I/O):

  pass A   stream chunks (graph.io.iter_edges or any [k, 2] chunk iterator)
           and spill each edge to its ψ-owner's bin (vertical owner =
           block(src)); with ``symmetrize`` a second pass over the source
           appends the reversed edges AFTER all forward ones, preserving
           ``symmetrize_edges``'s concat order.
  pass B   per bin: (dedup when symmetrizing — duplicate pairs share their
           src block, so per-bin dedup IS the global dedup), accumulate
           degrees, per-block nnz / planner measurements / structural
           partial sizes, write the packed-exchange index shards (the
           per-(i, j) sorted unique destination rows, delta/bit-width
           packed — repro_torch.exchange.codec; the unique site is already here,
           so the v2 shards cost no extra pass), and re-spill rows to
           destination-block bins for the horizontal striping.
  pass C/D per bin: pack the worker's stripe arrays against the GLOBAL
           E_cap (format.pack_worker_stripe — bitwise what build_stripes
           lays out) and write the memmap-able shards.

Peak host memory is O(chunk + bin + b * E_cap): one stream chunk, one
worker's bin (the unit the paper also requires to fit), and one stripe's
padded arrays.  The whole edge list is never resident.
"""
from __future__ import annotations

import os
import shutil

import numpy as np

from repro_torch.core import planner
from repro_torch.core.partition import Partition
from repro_torch.exchange import codec as xcodec
from repro_torch.graph.generators import dedup_edges
from repro_torch.graph.io import DEFAULT_CHUNK_EDGES, iter_edges
from repro_torch.store import format as fmt
from repro_torch.store.manifest import MANIFEST_FILE, Manifest

__all__ = ["ingest_edges"]


def _chunks(source, chunk_edges: int):
    if isinstance(source, str):
        yield from iter_edges(source, chunk_edges)
        return
    if isinstance(source, np.ndarray):
        source = np.asarray(source, dtype=np.int64).reshape(-1, 2)
        for lo in range(0, len(source), chunk_edges):
            yield source[lo: lo + chunk_edges]
        return
    yield from source


def _validate(chunk: np.ndarray, n: int) -> np.ndarray:
    chunk = np.asarray(chunk, dtype=np.int64).reshape(-1, 2)
    if chunk.size:
        lo, hi = int(chunk.min()), int(chunk.max())
        if lo < 0:
            raise ValueError(
                f"negative vertex id {lo} in edge stream — ids must be >= 0")
        if hi >= n:
            raise ValueError(
                f"vertex id {hi} out of range for |V|={n} — pass the correct "
                "n to ingest_edges (graph.io.load_edges + infer_n, or a "
                "pre-scan over iter_edges)")
    return chunk


def ingest_edges(
    source,
    n: int,
    b: int,
    out_dir: str,
    *,
    psi: str = "cyclic",
    chunk_edges: int = DEFAULT_CHUNK_EDGES,
    symmetrize: bool = False,
    keep_spill: bool = False,
    theta: float | str | None = None,
) -> Manifest:
    """Stream ``source`` (path, [m, 2] array, or chunk iterator) into a
    pre-partitioned block store at ``out_dir``; returns the Manifest.

    The resulting store loads back bitwise equal to
    ``partition_graph(edges, n, b, spec, psi=psi)`` (after
    ``symmetrize_edges`` when ``symmetrize``) for every GimvSpec — see
    manifest.load_partitioned.  ``symmetrize`` requires a re-iterable
    ``source`` (path or array: the stream is read twice).

    ``theta`` (a float, or 'auto' for the θ* of Lemma 3.3 on the streamed
    degrees) additionally writes the θ-split HYBRID shards — sparse-region
    edges as a 'sparse_vertical' striping, dense-region edges as a
    'dense_horizontal' striping whose gather column holds compact dense
    slots — which is what lets ``strategy='hybrid'`` run under
    ``residency='disk'`` without ever materializing the edge list.
    """
    assert n > 0, "ingest_edges needs the vertex count n >= 1"
    part = Partition(n=n, b=b, psi=psi)
    if symmetrize and not isinstance(source, (str, np.ndarray)):
        raise ValueError("symmetrize=True needs a re-iterable source "
                         "(path or array); got a one-shot iterator")
    os.makedirs(out_dir, exist_ok=True)
    # Invalidate any previous store FIRST: the manifest is written last (and
    # atomically), so a crash mid-ingest leaves a manifest-less directory
    # that open_store refuses — never a stale manifest over fresh shards.
    old_manifest = os.path.join(out_dir, MANIFEST_FILE)
    if os.path.exists(old_manifest):
        os.remove(old_manifest)
    spill_root = os.path.join(out_dir, "_spill")
    if os.path.exists(spill_root):
        shutil.rmtree(spill_root)

    vbins = fmt.EdgeBins(spill_root, b, "v")
    hbins = fmt.EdgeBins(spill_root, b, "h")
    dbins = fmt.EdgeBins(spill_root, b, "d") if theta is not None else None
    try:
        return _ingest_binned(source, n, b, out_dir, part, vbins, hbins,
                              chunk_edges=chunk_edges, symmetrize=symmetrize,
                              psi=psi, theta=theta, dbins=dbins)
    finally:
        vbins.close(remove=not keep_spill)
        hbins.close(remove=not keep_spill)
        if dbins is not None:
            dbins.close(remove=not keep_spill)
        if not keep_spill and os.path.exists(spill_root):
            shutil.rmtree(spill_root, ignore_errors=True)


def _ingest_binned(source, n, b, out_dir, part, vbins, hbins, *,
                   chunk_edges, symmetrize, psi, theta=None, dbins=None):
    peak_chunk = 0
    # ---- pass A: spill to source-block bins ------------------------------
    for chunk in _chunks(source, chunk_edges):
        chunk = _validate(chunk, n)
        peak_chunk = max(peak_chunk, len(chunk))
        vbins.append(part.block_of(chunk[:, 0]), chunk)
    if symmetrize:
        # reversed edges appended AFTER all forward ones: per-bin order then
        # matches symmetrize_edges' concat([edges, reversed]) restricted to
        # the bin, so keep-first dedup yields the identical edge order.
        for chunk in _chunks(source, chunk_edges):
            rev = _validate(chunk, n)[:, ::-1]
            vbins.append(part.block_of(rev[:, 0]), rev)

    # ---- pass B: per-bin measure (+dedup) and horizontal re-spill --------
    out_deg = np.zeros(n, dtype=np.int64)
    in_deg = np.zeros(n, dtype=np.int64)
    counts_sb_db = np.zeros((b, b), dtype=np.int64)   # [src block, dst block]
    partial_nnz = np.zeros((b, b), dtype=np.int64)    # [dst block, src block]
    rows = np.zeros((b, b), dtype=np.int64)
    d_max = np.zeros((b, b), dtype=np.int64)
    deg_hist = np.zeros((b, b, planner.DEG_HIST_BINS), dtype=np.int64)
    m_total = 0
    peak_bin = 0
    n_local = part.n_local
    pidx_sums: list[dict] = []

    def _write_pidx(w: int, packed_list: list) -> None:
        """One vertical worker's packed-exchange index shard: flat uint32
        delta-field words + a [b, 3] (word offset, count, width) directory,
        one row per destination block (empty pairs keep a zero row)."""
        meta = np.zeros((b, 3), dtype=np.int64)
        chunks = []
        off = 0
        for i, pk in enumerate(packed_list):
            if pk is not None:
                meta[i] = (off, pk.count, pk.width)
                if pk.words.size:
                    chunks.append(pk.words)
                    off += int(pk.words.size)
            else:
                meta[i, 0] = off
        words = (np.concatenate(chunks).astype(np.uint32)
                 if chunks else np.zeros(0, np.uint32))
        fmt.save_array(fmt.pidx_path(out_dir, w, "words"), words)
        fmt.save_array(fmt.pidx_path(out_dir, w, "meta"), meta)
        pidx_sums.append({
            "words": fmt.checksum_array(words, fmt.CHECKSUM_ALGORITHM),
            "meta": fmt.checksum_array(meta, fmt.CHECKSUM_ALGORITHM),
        })

    for j in range(b):
        e = vbins.read(j)
        if symmetrize:
            e = dedup_edges(e)
            vbins.replace(j, e)
        peak_bin = max(peak_bin, len(e))
        m_total += len(e)
        if len(e) == 0:
            _write_pidx(j, [None] * b)
            continue
        src, dst = e[:, 0], e[:, 1]
        out_deg += np.bincount(src, minlength=n)
        in_deg += np.bincount(dst, minlength=n)
        db = part.block_of(dst)
        dl = part.local_of(dst)
        counts_sb_db[j] = np.bincount(db, minlength=b)
        # structural partial sizes + per-block planner measurements: one
        # stable sort groups the bin by destination block (same pattern as
        # EdgeBins.append — no b full scans on the streaming path)
        order = np.argsort(db, kind="stable")
        db_s, dl_s = db[order], dl[order]
        bounds = np.searchsorted(db_s, np.arange(b + 1))
        packed_j: list = [None] * b
        for i in range(b):
            lo, hi = bounds[i], bounds[i + 1]
            if hi == lo:
                continue
            counts = np.bincount(dl_s[lo:hi])
            ids = np.flatnonzero(counts)          # sorted unique dest rows
            deg = counts[ids]
            packed_j[i] = xcodec.pack_ids(ids.astype(np.int64), n_local)
            partial_nnz[i, j] = int(deg.size)
            rows[i, j] = int(deg.size)
            d_max[i, j] = int(deg.max())
            deg_hist[i, j] = planner.deg_hist_of(deg)
        _write_pidx(j, packed_j)
        hbins.append(db, e)

    e_cap = max(int(counts_sb_db.max()), 1)
    block_nnz = counts_sb_db.T.copy()                 # [dst block i, src block j]

    # ---- pass C/D: pack + write stripe shards (digesting as we write:
    # per-block-row crc for seg/gat — the disk executor's fetch unit — and
    # whole-array crc for cnt: the store integrity digests) ------------------
    algo = fmt.CHECKSUM_ALGORITHM
    stripe_sums: dict[str, list[dict]] = {"vertical": [], "horizontal": []}

    def _write_stripe(striping: str, w: int, seg, gat, cnt) -> None:
        for name, arr in (("seg", seg), ("gat", gat), ("cnt", cnt)):
            fmt.save_array(fmt.stripe_path(out_dir, striping, w, name), arr)
        stripe_sums[striping].append({
            "seg": fmt.row_checksums(seg, algo),
            "gat": fmt.row_checksums(gat, algo),
            "cnt": fmt.checksum_array(cnt, algo),
        })

    for j in range(b):
        e = vbins.read(j)
        if len(e):
            src, dst = e[:, 0], e[:, 1]
            seg, gat, cnt = fmt.pack_worker_stripe(
                part.block_of(dst), part.local_of(dst), part.local_of(src),
                b, e_cap)
        else:
            seg = np.zeros((b, e_cap), np.int32)
            gat = np.zeros((b, e_cap), np.int32)
            cnt = np.zeros((b,), np.int32)
        _write_stripe("vertical", j, seg, gat, cnt)
    for i in range(b):
        e = hbins.read(i)
        if len(e):
            src, dst = e[:, 0], e[:, 1]
            seg, gat, cnt = fmt.pack_worker_stripe(
                part.block_of(src), part.local_of(dst), part.local_of(src),
                b, e_cap)
        else:
            seg = np.zeros((b, e_cap), np.int32)
            gat = np.zeros((b, e_cap), np.int32)
            cnt = np.zeros((b,), np.int32)
        _write_stripe("horizontal", i, seg, gat, cnt)

    # ---- θ-split post-pass: hybrid shards (sparse_vertical +
    # dense_horizontal) from the same spill bins, no edge-list resurrection.
    # Runs after pass B so out_deg is complete: the θ mask needs the full
    # degrees, and 'auto' resolves θ* exactly as the engine does.
    hybrid_doc = None
    whole_arrays = [("out_deg", out_deg), ("in_deg", in_deg),
                    ("nnz", block_nnz), ("partial_nnz", partial_nnz),
                    ("rows", rows), ("d_max", d_max), ("deg_hist", deg_hist)]
    if theta is not None:
        hybrid_doc = _write_hybrid_shards(
            out_dir, part, n, b, theta, out_deg, in_deg, m_total,
            vbins, dbins, stripe_sums, whole_arrays, _write_stripe)

    array_sums: dict[str, str] = {}
    for name, arr in whole_arrays:
        fmt.save_array(fmt.array_path(out_dir, name), arr)
        array_sums[name] = fmt.checksum_array(arr, algo)

    manifest = Manifest(
        root=out_dir, n=n, m=m_total, b=b, psi=psi, symmetrized=symmetrize,
        e_cap=e_cap, partial_cap=max(int(partial_nnz.max()), 1),
        hybrid=hybrid_doc,
        checksums={"algorithm": algo, "arrays": array_sums,
                   "stripes": stripe_sums, "pidx": pidx_sums},
        ingest={
            "chunk_edges": int(chunk_edges),
            "peak_chunk_rows": int(peak_chunk),
            "peak_bin_rows": int(peak_bin),
            # the bounded-memory model the round-trip tests assert on:
            # one chunk + one bin + one padded stripe, never the whole list
            "peak_host_rows_model": int(peak_chunk + peak_bin + b * e_cap),
            "source": source if isinstance(source, str) else "<stream>",
        })
    manifest.save()
    return manifest


def _write_hybrid_shards(out_dir, part, n, b, theta, out_deg, in_deg, m_total,
                         vbins, dbins, stripe_sums, whole_arrays,
                         _write_stripe):
    """θ-split the binned edges into the hybrid shard pair (paper §3.5).

    Sparse-region edges (src out-degree < θ) keep the vertical layout per
    source bin; dense-region edges are re-spilled to destination-block bins
    and packed horizontally with the compact dense SLOT in the gather column
    — bitwise what ``partition.build_hybrid`` lays out, because the θ mask
    preserves each bin's edge order and ``pack_worker_stripe``'s stable
    per-bin lexsort is ``build_stripes``'s global one restricted to the
    owner.  Returns the manifest ``hybrid`` doc.
    """
    from repro_torch.core import cost_model
    from repro_torch.core.partition import dense_region_of
    from repro_torch.graph.stats import GraphStats

    if theta == "auto":
        stats = GraphStats(n=n, n_edges=m_total, out_deg=out_deg,
                           in_deg=in_deg, density=float(m_total) / float(n) ** 2)
        theta, _ = cost_model.theta_star(b, n, stats)
    theta = float(theta)
    is_dense = out_deg >= theta
    region, slot_of = dense_region_of(part, is_dense, theta)

    # split pass: θ-mask each source bin, count both regions, spill dense
    # edges to destination-block bins (their horizontal owner).
    sparse_nnz = np.zeros((b, b), dtype=np.int64)    # [dst block, src block]
    dense_nnz = np.zeros((b, b), dtype=np.int64)     # [dst block, src block]
    sparse_partial = np.zeros((b, b), dtype=np.int64)
    sparse_m = dense_m = 0
    for j in range(b):
        e = vbins.read(j)
        if not len(e):
            continue
        mask = is_dense[e[:, 0]]
        s_e, d_e = e[~mask], e[mask]
        sparse_m += len(s_e)
        dense_m += len(d_e)
        if len(s_e):
            sdb = part.block_of(s_e[:, 1])
            sdl = part.local_of(s_e[:, 1])
            sparse_nnz[:, j] = np.bincount(sdb, minlength=b)
            order = np.argsort(sdb, kind="stable")
            db_s, dl_s = sdb[order], sdl[order]
            bounds = np.searchsorted(db_s, np.arange(b + 1))
            for i in range(b):
                lo, hi = bounds[i], bounds[i + 1]
                if hi > lo:
                    sparse_partial[i, j] = len(np.unique(dl_s[lo:hi]))
        if len(d_e):
            ddb = part.block_of(d_e[:, 1])
            dense_nnz[:, j] = np.bincount(ddb, minlength=b)
            dbins.append(ddb, d_e)
    sparse_e_cap = max(int(sparse_nnz.max()), 1)
    dense_e_cap = max(int(dense_nnz.max()), 1)

    stripe_sums["sparse_vertical"] = []
    stripe_sums["dense_horizontal"] = []
    for j in range(b):
        e = vbins.read(j)
        s_e = e[~is_dense[e[:, 0]]] if len(e) else e
        if len(s_e):
            src, dst = s_e[:, 0], s_e[:, 1]
            seg, gat, cnt = fmt.pack_worker_stripe(
                part.block_of(dst), part.local_of(dst), part.local_of(src),
                b, sparse_e_cap)
        else:
            seg = np.zeros((b, sparse_e_cap), np.int32)
            gat = np.zeros((b, sparse_e_cap), np.int32)
            cnt = np.zeros((b,), np.int32)
        _write_stripe("sparse_vertical", j, seg, gat, cnt)
    for i in range(b):
        e = dbins.read(i)
        if len(e):
            src, dst = e[:, 0], e[:, 1]
            seg, gat, cnt = fmt.pack_worker_stripe(
                part.block_of(src), part.local_of(dst),
                slot_of[src].astype(np.int64), b, dense_e_cap)
        else:
            seg = np.zeros((b, dense_e_cap), np.int32)
            gat = np.zeros((b, dense_e_cap), np.int32)
            cnt = np.zeros((b,), np.int32)
        _write_stripe("dense_horizontal", i, seg, gat, cnt)

    whole_arrays.append(("sparse_nnz", sparse_nnz))
    whole_arrays.append(("dense_nnz", dense_nnz))
    return {
        "theta": theta,
        "sparse_e_cap": sparse_e_cap,
        "dense_e_cap": dense_e_cap,
        "sparse_partial_cap": max(int(sparse_partial.max()), 1),
        "d_cap": int(region.d_cap),
        "sparse_m": int(sparse_m),
        "dense_m": int(dense_m),
    }

"""Wrappers of the scatter-combine kernels: the receive side of the compact
sparse exchange (csrc/scatter_combine.cu, one value per slot;
csrc/scatter_combine_multi.cu, Q values per slot) and of the packed exchange,
whose ids arrive bit-packed (csrc/packed_scatter_combine.cu and
csrc/packed_scatter_combine_multi.cu).

Each wrapper on a CUDA tensor launches its Hopper kernel (or raises); on a
CPU tensor it runs the plain version in ref.py.  Its ``launches`` counts
kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _common
from repro_torch.kernels.scatter_combine.ref import (packed_scatter_combine_multi_ref,
                                                     packed_scatter_combine_ref,
                                                     scatter_combine_multi_ref,
                                                     scatter_combine_ref)

__all__ = ["scatter_combine_gimv", "scatter_combine_gimv_multi",
           "packed_scatter_combine_gimv", "packed_scatter_combine_gimv_multi"]

PACKED_WIDTHS = (4, 8, 16, 32)


def scatter_combine_gimv(idx: torch.Tensor, val: torch.Tensor, n_local: int, *,
                         semiring: str) -> torch.Tensor:
    """r[s, n] = combineAll_{k, t : idx[s,k,t] == n} val[s,k,t]; idx outside
    [0, n_local) is dropped and an unreached n gets the identity.

    idx: int32 [S, B, cap] -- S receiving sets, B senders, each row (s, k) a
    compacted partial: strictly ascending unique indices padded with n_local
    (sparse_exchange.compact_partials).  The kernel folds the B rows of a set
    in sender order and relies on that layout; the plain version accepts any
    idx.  val: float32 or int32 [S, B, cap] -> r: [S, n_local].
    """
    _common.check_semiring(semiring)
    dev = val.device
    _common.check_tensor("val", val, dtypes=(torch.float32, torch.int32), ndim=3, device=dev)
    _common.check_tensor("idx", idx, dtypes=(torch.int32,), ndim=3, device=dev)
    if idx.shape != val.shape:
        raise ValueError(f"idx {tuple(idx.shape)} and val {tuple(val.shape)} differ")
    if n_local <= 0:
        raise ValueError(f"n_local must be positive, got {n_local}")
    if _common.use_plain(dev):
        return scatter_combine_ref(idx, val, n_local, semiring=semiring)
    sets, senders, cap = idx.shape
    out = torch.empty((sets, n_local), dtype=val.dtype, device=dev)
    if sets == 0:
        return out
    if senders == 0:
        return out.fill_(_common.identity(semiring, val.dtype))
    from repro_torch.kernels.build import check_rc, load

    fn = load("scatter_combine")
    with torch.cuda.device(dev):
        rc = fn(idx.data_ptr(), val.data_ptr(), out.data_ptr(), sets, senders, cap, n_local,
                _common.SEMIRING_ID[semiring], _common.VALUE_TYPE_ID[val.dtype],
                _common.current_stream(dev))
    check_rc(rc, "scatter_combine")
    scatter_combine_gimv.launches += 1
    return out


scatter_combine_gimv.launches = 0


def scatter_combine_gimv_multi(idx: torch.Tensor, val: torch.Tensor, n_local: int, *,
                               semiring: str) -> torch.Tensor:
    """r[s, n, q] = combineAll_{k, t : idx[s,k,t] == n} val[s,k,t,q]; idx
    outside [0, n_local) is dropped and an unreached n gets the identity.

    idx: int32 [S, B, cap], one index set shared by the Q columns of a row;
    val: float32 or int32 [S, B, cap, Q] -> r: [S, n_local, Q].

    Precondition of the kernel: every row (s, k) of idx is strictly
    ascending below n_local and then holds only the sentinel n_local
    (``sparse_exchange.compact_partials`` gives that layout, with
    ``batched=True`` one index set per row).  One launch: a block per tile
    of a set's output rows and slab of up to 64 columns searches each row
    for the slots that land in its tile and folds them in sender order, so
    a row out of order gives a wrong result, not an error; the wrapper does
    not check it, as that would cost more than the kernel.  The plain
    version accepts any idx.
    """
    _common.check_semiring(semiring)
    dev = val.device
    _common.check_tensor("val", val, dtypes=(torch.float32, torch.int32), ndim=4, device=dev)
    _common.check_tensor("idx", idx, dtypes=(torch.int32,), ndim=3, device=dev)
    if idx.shape != val.shape[:3]:
        raise ValueError(f"idx {tuple(idx.shape)} does not match val {tuple(val.shape)}")
    if n_local <= 0:
        raise ValueError(f"n_local must be positive, got {n_local}")
    if _common.use_plain(dev):
        return scatter_combine_multi_ref(idx, val, n_local, semiring=semiring)
    sets, senders, cap, nq = val.shape
    out = torch.empty((sets, n_local, nq), dtype=val.dtype, device=dev)
    if sets == 0 or nq == 0:
        return out
    if senders == 0:
        return out.fill_(_common.identity(semiring, val.dtype))
    from repro_torch.kernels.build import check_rc, load

    fn = load("scatter_combine_multi")
    with torch.cuda.device(dev):
        rc = fn(idx.data_ptr(), val.data_ptr(), out.data_ptr(), sets, senders, cap, n_local,
                nq, _common.SEMIRING_ID[semiring], _common.VALUE_TYPE_ID[val.dtype],
                _common.current_stream(dev))
    check_rc(rc, "scatter_combine_multi")
    scatter_combine_gimv_multi.launches += 1
    return out


scatter_combine_gimv_multi.launches = 0


def _check_packed(words: torch.Tensor, val: torch.Tensor, n_out: int, set_slots: int,
                  n_local: int, width: int, senders: int, semiring: str, val_ndim: int) -> None:
    _common.check_semiring(semiring)
    dev = val.device
    _common.check_tensor("val", val, dtypes=(torch.float32, torch.int32), ndim=val_ndim,
                         device=dev)
    _common.check_tensor("words", words, dtypes=(torch.uint32,), ndim=1, device=dev)
    if width not in PACKED_WIDTHS:
        raise ValueError(f"width must be one of {PACKED_WIDTHS}, got {width}")
    n_slots = val.shape[0]
    per_word = 32 // width
    if n_slots % per_word or words.shape[0] != n_slots // per_word:
        raise ValueError(f"{n_slots} slots at width {width} need {-(-n_slots // per_word)} "
                         f"words (and a multiple of {per_word} slots); got {words.shape[0]}")
    if set_slots <= 0 or n_slots % set_slots:
        raise ValueError(f"set_slots {set_slots} must divide the {n_slots} slots")
    if senders <= 0 or set_slots % senders:
        raise ValueError(f"senders {senders} must divide set_slots {set_slots}")
    if n_local <= 0 or n_out < 0 or n_out >= 2**31:
        raise ValueError(f"bad n_local {n_local} / n_out {n_out}")


def packed_scatter_combine_gimv(words: torch.Tensor, val: torch.Tensor, n_out: int, *,
                                set_slots: int, n_local: int, width: int, semiring: str,
                                senders: int) -> torch.Tensor:
    """r[o] = combineAll_{t : target(t) == o} val[t], the ids decoded from
    bit-packed words inside the kernel.

    words: uint32 [T * width / 32], 32 / width ids per word, LSB first
    (``exchange.codec.pack_uniform``); val: float32 or int32 [T], the payload
    in the same static order.  Slot t of set s = t // set_slots targets row
    id(t) + s * (n_local + 1); an id of n_local or more (the sentinel) or a
    target of n_out or more is dropped, so every set's drop slot, and every
    output no slot reaches, holds the identity.  -> r: [n_out].

    The arguments are the JAX package's ``packed_scatter_combine_gimv``'s
    plus ``senders``: each set's slots are ``senders`` rows of
    set_slots / senders slots.  Precondition of the kernel: in every sender
    row the ids below n_local are strictly ascending and followed only by
    ids of n_local or more (``exchange.plan.build_exchange``'s rows are: a
    sorted ``np.unique`` set padded with the sentinel, and it refuses rows
    that are not, with ``exchange.plan.check_sorted_rows``; hold words from
    elsewhere to that check before they reach the card).  One launch: a
    block per tile of a set's output rows searches each row for the slots
    that land in its tile and folds them in sender order, so rows out of
    order give a wrong result, not an error; the wrapper does not check
    them, as that would cost more than the kernel.  The plain version
    accepts any ids.
    Unlike the Pallas kernel, which folds the sentinel slots' values into
    each set's drop slot, both leave the drop slot at the identity; the
    exchange slices it off either way.
    """
    _check_packed(words, val, n_out, set_slots, n_local, width, senders, semiring, 1)
    dev = val.device
    if _common.use_plain(dev):
        return packed_scatter_combine_ref(words, val, n_out, set_slots=set_slots,
                                          n_local=n_local, width=width, semiring=semiring)
    out = torch.empty((n_out,), dtype=val.dtype, device=dev)
    from repro_torch.kernels.build import check_rc, load

    fn = load("packed_scatter_combine")
    with torch.cuda.device(dev):
        rc = fn(words.data_ptr(), val.data_ptr(), out.data_ptr(), val.shape[0] // set_slots,
                set_slots, senders, n_local, n_out, width, _common.SEMIRING_ID[semiring],
                _common.VALUE_TYPE_ID[val.dtype], _common.current_stream(dev))
    check_rc(rc, "packed_scatter_combine")
    packed_scatter_combine_gimv.launches += 1
    return out


packed_scatter_combine_gimv.launches = 0


def packed_scatter_combine_gimv_multi(words: torch.Tensor, val: torch.Tensor, n_out: int, *,
                                      set_slots: int, n_local: int, width: int,
                                      semiring: str, senders: int) -> torch.Tensor:
    """Q-wide :func:`packed_scatter_combine_gimv`: every slot's Q values go to
    its one target row.  words: uint32 [T * width / 32]; val: float32 or
    int32 [T, Q] -> r: [n_out, Q].  The same precondition and the same one
    launch, each block a tile of a set's output rows and a slab of up to 64
    columns, folded in sender order."""
    _check_packed(words, val, n_out, set_slots, n_local, width, senders, semiring, 2)
    dev = val.device
    if _common.use_plain(dev):
        return packed_scatter_combine_multi_ref(words, val, n_out, set_slots=set_slots,
                                                n_local=n_local, width=width,
                                                semiring=semiring)
    nq = val.shape[1]
    out = torch.empty((n_out, nq), dtype=val.dtype, device=dev)
    if nq == 0:
        return out
    from repro_torch.kernels.build import check_rc, load

    fn = load("packed_scatter_combine_multi")
    with torch.cuda.device(dev):
        rc = fn(words.data_ptr(), val.data_ptr(), out.data_ptr(), val.shape[0] // set_slots,
                set_slots, senders, n_local, n_out, nq, width, _common.SEMIRING_ID[semiring],
                _common.VALUE_TYPE_ID[val.dtype], _common.current_stream(dev))
    check_rc(rc, "packed_scatter_combine_multi")
    packed_scatter_combine_gimv_multi.launches += 1
    return out


packed_scatter_combine_gimv_multi.launches = 0

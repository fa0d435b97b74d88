"""repro_torch.exchange -- the partition-centric packed exchange.

Static per-(source, destination)-block index sets computed once at prepare
time, delta/bit-width packed (codec, numpy), summarized into a hashable
:class:`ExchangePlan` (plan, numpy), with the per-iteration send / receive /
delta primitives in runtime (torch).  ``exchange='packed'`` on the engine or
the server selects this path; ``exchange='auto'`` gates it on
``cost_model.prefer_packed_exchange``.
"""
from repro_torch.exchange.codec import (
    DEVICE_WIDTHS,
    HEADER_BYTES,
    PackedIds,
    device_width,
    pack_ids,
    pack_uniform,
    packed_nbytes,
    unpack_ids,
    unpack_uniform,
)
from repro_torch.exchange.plan import (
    ExchangePlan,
    build_exchange,
    format_exchange,
    row_sets_from_stripes,
    summarize_row_sizes,
)
from repro_torch.exchange.runtime import (
    delta_update,
    gather_payload,
    pair_slot_mask,
    payload_logical,
    scatter_payload,
)

__all__ = [
    "PackedIds", "HEADER_BYTES", "DEVICE_WIDTHS",
    "pack_ids", "unpack_ids", "packed_nbytes",
    "device_width", "pack_uniform", "unpack_uniform",
    "ExchangePlan", "build_exchange", "format_exchange",
    "row_sets_from_stripes", "summarize_row_sizes",
    "gather_payload", "scatter_payload", "payload_logical",
    "delta_update", "pair_slot_mask",
]

"""The tiered state store: the card's table and arena, host RAM, disk
segments (``tiered.py``). The engines build theirs with
``store_from_config`` from their ``tier_*`` keywords or the
``STpu_TIER_DEVICE_BYTES`` / ``STpu_TIER_HOST_BYTES`` / ``STpu_TIER_DIR``
environment variables."""

from .tiered import (NULL_STORE, TIER_DEVICE_ENV, TIER_DIR_ENV,
                     TIER_HOST_ENV, FrontierRef, NullStore, TieredStore,
                     load_cold_refs, map_segment_visited, store_from_config)

__all__ = [
    "TIER_DEVICE_ENV", "TIER_HOST_ENV", "TIER_DIR_ENV",
    "FrontierRef", "NullStore", "NULL_STORE", "TieredStore",
    "load_cold_refs", "map_segment_visited", "store_from_config",
]

"""Tiered artifact store for published on-disk artifacts (chunk caches,
block caches, snapshots): one directory layout + crash-safe manifest,
atomic publish with orphan GC, pin/drop refcounts, byte budgets with
cost-aware eviction. Own copy of the JAX package's ``store/`` with its
``__all__``; see :mod:`dmlc_tpu_torch.store.manager`."""

from dmlc_tpu_torch.store.journal import AppendJournal
from dmlc_tpu_torch.store.manager import (
    COMPACT_BYTES,
    COMPACT_LINES,
    MAGIC_TIERS,
    MANIFEST_NAME,
    STORE_DIRNAME,
    TIER_COST,
    TIERS,
    ArtifactStore,
    current_publish_owner,
    note_missing,
    publish_owner,
    reset_stores,
    signature_hash,
    store_counters,
    store_for,
    tier_for_magic,
)

__all__ = [
    "AppendJournal",
    "ArtifactStore", "COMPACT_BYTES", "COMPACT_LINES", "MAGIC_TIERS",
    "MANIFEST_NAME", "STORE_DIRNAME", "TIER_COST", "TIERS",
    "current_publish_owner", "note_missing", "publish_owner",
    "reset_stores", "signature_hash", "store_counters",
    "store_for", "tier_for_magic",
]

"""The on-device ANN plane: semantic-cache similarity and RAG retrieval as
one ``top_k(Q @ bank_t)`` step over an embedding bank that lives on the
card.

The port's copy of ``semantic_router_tpu.ann``, on one device: the bank
(``bank``), its scoring programs (``search``), the host overflow tier and
its promotion / eviction / compaction policy (``tiering``), the named
indexes and their maintenance thread (``plane``), and the state-plane
sync that converges a replica's index on the fleet's rows (``sync``).
"""

from .bank import DeviceBank, measure_recall, normalize_rows, tier_for
from .knobs import BANK_MODES, normalize_ann
from .plane import AnnIndex, AnnPlane
from .search import AnnSearcher, TopKPrograms
from .sync import VersionedRowSync, cache_index_sync
from .tiering import HostTier, TierPolicy

__all__ = [
    "AnnIndex",
    "AnnPlane",
    "AnnSearcher",
    "BANK_MODES",
    "DeviceBank",
    "HostTier",
    "TierPolicy",
    "TopKPrograms",
    "VersionedRowSync",
    "cache_index_sync",
    "measure_recall",
    "normalize_ann",
    "normalize_rows",
    "tier_for",
]

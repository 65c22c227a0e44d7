"""Router replay: every routed response recorded (``ReplayRecorder`` on
``Router.response_hooks``) to an in-memory ring with optional JSONL
persistence, a SQLite file or a Postgres table, and the counterfactual
re-drive of a decision record under another config (``replay_decision``,
``replay_diff``, ``rederive_cascade_skips``).  The record layout, the
JSONL lines and the SQL rows are the reference package's: a store file
written by either loads in the other."""

from .recorder import (
    ReplayRecord,
    ReplayRecorder,
    ReplayStore,
    raw_signal_matches_from_record,
    rederive_cascade_skips,
    replay_decision,
    replay_diff,
    signal_matches_from_record,
)

__all__ = ["ReplayRecord", "ReplayRecorder", "ReplayStore",
           "raw_signal_matches_from_record", "rederive_cascade_skips",
           "replay_decision", "replay_diff", "signal_matches_from_record"]

"""The routing flywheel: decision records → trained policies →
counterfactual promotion.

The port's copy of ``semantic_router_tpu.flywheel``.  The closed loop::

    route() ──records──▶ explain ring / durable mirror
                              │ CorpusExporter (+ verdict labels from
                              │  note_outcome / the learning ledgers)
                              ▼
                       versioned corpus rows
                              │ train_policies (cost_bandit + the
                              │  selection trainers, on the router's
                              │  device)
                              ▼
                       JSON policy artifacts
                              │ counterfactual_eval (replayed against
                              │  the corpus, bootstrap CIs — no live
                              │  traffic)
                              ▼
                  shadow ─▶ canary ─▶ promote   (SLO burn ⇒ rollback)

The bandit and the evaluator are float64 numpy on the host, bit for bit
the reference's: a corpus exported by either package trains the same
``cost_bandit`` blob and evaluates to the same report.  The features
hash signal matches whose learned confidences came from the engine.
``flywheel.enabled: false`` (the default) builds none of this.
"""

from .controller import STATES, FlywheelController
from .corpus import (
    ROW_SCHEMA,
    ROW_VERSION,
    CorpusExporter,
    OutcomeBook,
    record_to_row,
    reward_for,
    row_to_json,
    rows_to_routing_records,
    validate_row,
)
from .evaluator import RewardModel, bootstrap_ci, counterfactual_eval
from .features import (
    DEFAULT_DIM,
    FEATURE_KIND,
    feature_dim,
    row_features,
    signal_features,
    signals_obj_features,
)
from .policy import CostAwareBanditSelector
from .trainer import load_policy, train_policies

__all__ = [
    "CorpusExporter", "CostAwareBanditSelector", "DEFAULT_DIM",
    "FEATURE_KIND", "FlywheelController", "OutcomeBook", "ROW_SCHEMA",
    "ROW_VERSION", "RewardModel", "STATES", "bootstrap_ci",
    "counterfactual_eval", "feature_dim", "load_policy",
    "record_to_row", "reward_for", "row_features", "row_to_json",
    "rows_to_routing_records", "signal_features",
    "signals_obj_features", "train_policies", "validate_row",
]

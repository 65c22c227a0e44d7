"""Overload control and graceful degradation, and the upstream health
plane.

The closed loop from observability to behaviour: a deterministic,
hysteresis-guarded shed ladder (``controller.py``) driven by the SLO
monitor's burn-rate alerts and the runtime-stats pressure providers,
priority-aware (``priority.py``) and cost-model-informed
(``costmodel.py``); and per-(model, endpoint) circuit breakers with a
retry budget and deadlines for the forward path (``upstream.py``).
"""

from .controller import (
    DegradationController,
    Disposition,
    L0_NORMAL,
    L1_SHED_OPTIONAL,
    L2_BROWNOUT,
    L3_ADMISSION,
    L4_FAIL_STATIC,
    LEVEL_NAMES,
    TokenBucket,
    default_degradation_controller,
    level_name,
)
from .costmodel import CostModel, make_path_cost_prior
from .priority import (
    PRIORITY_CLASSES,
    PRIORITY_HEADER,
    PriorityResolver,
    rank_of,
)
from .upstream import (
    DEADLINE_HEADER,
    UpstreamHealth,
    attempt_timeout,
    parse_deadline,
)

__all__ = [
    "DegradationController", "Disposition", "TokenBucket", "CostModel",
    "PriorityResolver", "PRIORITY_CLASSES", "PRIORITY_HEADER",
    "default_degradation_controller", "make_path_cost_prior", "rank_of",
    "level_name", "LEVEL_NAMES",
    "L0_NORMAL", "L1_SHED_OPTIONAL", "L2_BROWNOUT", "L3_ADMISSION",
    "L4_FAIL_STATIC",
    "UpstreamHealth", "parse_deadline", "attempt_timeout",
    "DEADLINE_HEADER",
]

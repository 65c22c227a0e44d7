from .bootstrap import apply_ann_knobs, apply_cascade_knobs, \
    apply_flywheel_knobs, apply_observability_knobs, apply_packing_knobs, \
    apply_kernel_knobs, apply_resilience_knobs, attach_config_watcher, \
    attach_otlp, \
    apply_stateplane_knobs, apply_upstream_knobs, build_engine, \
    build_router, checkpoint_architecture, close_ann, close_stateplane, \
    modernbert_state, select_attention_impl, serve, warm_engine
from .registry import RuntimeRegistry

__all__ = ["RuntimeRegistry", "apply_ann_knobs", "apply_cascade_knobs",
           "apply_flywheel_knobs",
           "apply_observability_knobs", "apply_packing_knobs",
           "apply_kernel_knobs", "attach_config_watcher", "attach_otlp",
           "apply_resilience_knobs", "apply_stateplane_knobs",
           "apply_upstream_knobs", "build_engine", "build_router",
           "checkpoint_architecture", "close_ann", "close_stateplane",
           "modernbert_state", "select_attention_impl", "serve",
           "warm_engine"]

from .bootstrap import apply_quant_knobs, build_engine, build_router, \
    modernbert_state, select_attention_impl, serve

__all__ = ["apply_quant_knobs", "build_engine", "build_router",
           "modernbert_state", "select_attention_impl", "serve"]

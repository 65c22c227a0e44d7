from .bootstrap import build_engine, build_router, select_attention_impl, \
    serve

__all__ = ["build_engine", "build_router", "select_attention_impl", "serve"]

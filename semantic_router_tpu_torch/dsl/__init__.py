"""The routing DSL: ``compile_dsl`` (text → validated RouterConfig),
``emit_yaml`` and ``decompile`` (RouterConfig → DSL)."""

from .compiler import (
    DSLCompileError,
    compile_dsl,
    compile_program,
    decompile,
    emit_yaml,
)
from .parser import DSLSyntaxError, parse

__all__ = ["DSLCompileError", "DSLSyntaxError", "compile_dsl",
           "compile_program", "decompile", "emit_yaml", "parse"]

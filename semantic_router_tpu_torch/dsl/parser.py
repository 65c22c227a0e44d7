"""Routing DSL: a programmable config language compiling to RouterConfig.

The port's copy of the routing DSL's grammar: a lexer and a
recursive-descent parser into a small AST, which ``compiler.py`` turns
into a ``RouterConfig``.  The grammar:

    model "qwen3-32b" { param_size: "32B" quality: 0.96 tags: [premium] }

    signal keyword code_kw { method: bm25 keywords: ["code", "debug"] }
    signal domain "computer science" {}
    signal embedding support { threshold: 0.75
                               candidates: ["reset password"] }

    decision cs_route priority 200 {
        when domain("computer science") and not authz(admin)
        route to "qwen3-32b" weight 0.7 reasoning high
        route to "qwen3-8b" weight 0.3
        algorithm elo
        plugin semantic-cache { similarity_threshold: 0.85 }
    }

    default model "qwen3-8b"

`when` expressions are the decision rule tree (and/or/not + parentheses);
signal references are `family(name)`. Compilation produces the same
RouterConfig the YAML loader builds, then runs the config validator:
one semantic model, two syntaxes.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

# ---------------------------------------------------------------------------
# Lexer
# ---------------------------------------------------------------------------

_TOKEN_SPEC = [
    ("COMMENT", r"#[^\n]*"),
    ("STRING", r'"(?:[^"\\]|\\.)*"'),
    ("NUMBER", r"-?\d+(?:\.\d+)?"),
    ("LBRACE", r"\{"),
    ("RBRACE", r"\}"),
    ("LBRACKET", r"\["),
    ("RBRACKET", r"\]"),
    ("LPAREN", r"\("),
    ("RPAREN", r"\)"),
    ("COLON", r":"),
    ("COMMA", r","),
    ("IDENT", r"[A-Za-z_][\w.-]*"),
    ("NEWLINE", r"\n"),
    ("WS", r"[ \t\r]+"),
    ("UNKNOWN", r"."),
]
_LEXER = re.compile("|".join(f"(?P<{n}>{p})" for n, p in _TOKEN_SPEC))


@dataclass
class Token:
    kind: str
    value: str
    line: int


class DSLSyntaxError(ValueError):
    def __init__(self, message: str, line: int) -> None:
        super().__init__(f"line {line}: {message}")
        self.line = line


def lex(text: str) -> List[Token]:
    out: List[Token] = []
    line = 1
    for m in _LEXER.finditer(text):
        kind = m.lastgroup or "UNKNOWN"
        value = m.group(0)
        if kind == "NEWLINE":
            line += 1
            continue
        if kind in ("WS", "COMMENT"):
            continue
        if kind == "UNKNOWN":
            raise DSLSyntaxError(f"unexpected character {value!r}", line)
        if kind == "STRING":
            value = value[1:-1].replace('\\"', '"').replace("\\\\", "\\")
        out.append(Token(kind, value, line))
    out.append(Token("EOF", "", line))
    return out


# ---------------------------------------------------------------------------
# AST
# ---------------------------------------------------------------------------


@dataclass
class SignalDecl:
    family: str
    name: str
    props: Dict[str, Any] = field(default_factory=dict)


@dataclass
class ModelDecl:
    name: str
    props: Dict[str, Any] = field(default_factory=dict)


@dataclass
class RouteDecl:
    model: str
    weight: float = 1.0
    reasoning: str = ""  # "", low, medium, high
    lora: str = ""


@dataclass
class PluginDecl:
    type: str
    props: Dict[str, Any] = field(default_factory=dict)


@dataclass
class WhenExpr:
    op: str = ""  # and | or | not | "" (leaf)
    children: List["WhenExpr"] = field(default_factory=list)
    family: str = ""
    name: str = ""


@dataclass
class DecisionDecl:
    name: str
    priority: int = 0
    when: Optional[WhenExpr] = None
    routes: List[RouteDecl] = field(default_factory=list)
    algorithm: str = "static"
    algorithm_props: Dict[str, Any] = field(default_factory=dict)
    plugins: List[PluginDecl] = field(default_factory=list)


@dataclass
class Program:
    models: List[ModelDecl] = field(default_factory=list)
    signals: List[SignalDecl] = field(default_factory=list)
    decisions: List[DecisionDecl] = field(default_factory=list)
    projections: Dict[str, Any] = field(default_factory=dict)
    default_model: str = ""
    strategy: str = "priority"


# ---------------------------------------------------------------------------
# Parser (recursive descent)
# ---------------------------------------------------------------------------


class Parser:
    def __init__(self, tokens: List[Token]) -> None:
        self.tokens = tokens
        self.i = 0

    def peek(self) -> Token:
        return self.tokens[self.i]

    def next(self) -> Token:
        tok = self.tokens[self.i]
        self.i += 1
        return tok

    def expect(self, kind: str, value: Optional[str] = None) -> Token:
        tok = self.next()
        if tok.kind != kind or (value is not None and tok.value != value):
            want = value or kind
            raise DSLSyntaxError(
                f"expected {want!r}, got {tok.value!r}", tok.line)
        return tok

    def accept(self, kind: str, value: Optional[str] = None) -> Optional[Token]:
        tok = self.peek()
        if tok.kind == kind and (value is None or tok.value == value):
            return self.next()
        return None

    # -- values ------------------------------------------------------------

    def parse_value(self) -> Any:
        tok = self.next()
        if tok.kind == "STRING":
            return tok.value
        if tok.kind == "NUMBER":
            return float(tok.value) if "." in tok.value else int(tok.value)
        if tok.kind == "IDENT":
            if tok.value in ("true", "false"):
                return tok.value == "true"
            return tok.value
        if tok.kind == "LBRACKET":
            items = []
            while not self.accept("RBRACKET"):
                items.append(self.parse_value())
                self.accept("COMMA")
            return items
        if tok.kind == "LBRACE":
            self.i -= 1
            return self.parse_props()
        raise DSLSyntaxError(f"expected a value, got {tok.value!r}", tok.line)

    def parse_props(self) -> Dict[str, Any]:
        self.expect("LBRACE")
        props: Dict[str, Any] = {}
        while not self.accept("RBRACE"):
            key = self.expect("IDENT").value
            self.expect("COLON")
            props[key] = self.parse_value()
        return props

    # -- when expression ---------------------------------------------------

    def parse_when(self) -> WhenExpr:
        return self._parse_or()

    def _parse_or(self) -> WhenExpr:
        left = self._parse_and()
        children = [left]
        while self.accept("IDENT", "or"):
            children.append(self._parse_and())
        if len(children) == 1:
            return left
        return WhenExpr(op="or", children=children)

    def _parse_and(self) -> WhenExpr:
        left = self._parse_unary()
        children = [left]
        while self.accept("IDENT", "and"):
            children.append(self._parse_unary())
        if len(children) == 1:
            return left
        return WhenExpr(op="and", children=children)

    def _parse_unary(self) -> WhenExpr:
        if self.accept("IDENT", "not"):
            return WhenExpr(op="not", children=[self._parse_unary()])
        if self.accept("LPAREN"):
            inner = self._parse_or()
            self.expect("RPAREN")
            return inner
        family = self.expect("IDENT").value
        self.expect("LPAREN")
        tok = self.next()
        if tok.kind not in ("IDENT", "STRING"):
            raise DSLSyntaxError(
                f"expected signal name, got {tok.value!r}", tok.line)
        name = tok.value
        self.expect("RPAREN")
        return WhenExpr(family=family, name=name)

    # -- declarations ------------------------------------------------------

    def parse_program(self) -> Program:
        prog = Program()
        while self.peek().kind != "EOF":
            tok = self.expect("IDENT")
            if tok.value == "model":
                name = self._name()
                props = self.parse_props() if self.peek().kind == "LBRACE" \
                    else {}
                prog.models.append(ModelDecl(name, props))
            elif tok.value == "signal":
                family = self.expect("IDENT").value
                name = self._name()
                props = self.parse_props() if self.peek().kind == "LBRACE" \
                    else {}
                prog.signals.append(SignalDecl(family, name, props))
            elif tok.value == "decision":
                prog.decisions.append(self._parse_decision())
            elif tok.value == "projections":
                prog.projections = self.parse_props()
            elif tok.value == "default":
                self.expect("IDENT", "model")
                prog.default_model = self._name()
            elif tok.value == "strategy":
                prog.strategy = self._name()
            else:
                raise DSLSyntaxError(
                    f"unknown declaration {tok.value!r}", tok.line)
        return prog

    def _name(self) -> str:
        tok = self.next()
        if tok.kind not in ("IDENT", "STRING"):
            raise DSLSyntaxError(f"expected a name, got {tok.value!r}",
                                 tok.line)
        return tok.value

    def _parse_decision(self) -> DecisionDecl:
        name = self._name()
        dec = DecisionDecl(name=name)
        if self.accept("IDENT", "priority"):
            dec.priority = int(self.expect("NUMBER").value)
        self.expect("LBRACE")
        while not self.accept("RBRACE"):
            kw = self.expect("IDENT")
            if kw.value == "when":
                dec.when = self.parse_when()
            elif kw.value == "route":
                self.expect("IDENT", "to")
                route = RouteDecl(model=self._name())
                while True:
                    if self.accept("IDENT", "weight"):
                        route.weight = float(self.expect("NUMBER").value)
                    elif self.accept("IDENT", "reasoning"):
                        route.reasoning = self.expect("IDENT").value
                    elif self.accept("IDENT", "lora"):
                        route.lora = self._name()
                    else:
                        break
                dec.routes.append(route)
            elif kw.value == "algorithm":
                dec.algorithm = self.expect("IDENT").value
                if self.peek().kind == "LBRACE":
                    dec.algorithm_props = self.parse_props()
            elif kw.value == "plugin":
                ptype = self.expect("IDENT").value
                props = self.parse_props() if self.peek().kind == "LBRACE" \
                    else {}
                dec.plugins.append(PluginDecl(ptype, props))
            else:
                raise DSLSyntaxError(
                    f"unknown decision clause {kw.value!r}", kw.line)
        return dec


def parse(text: str) -> Program:
    return Parser(lex(text)).parse_program()

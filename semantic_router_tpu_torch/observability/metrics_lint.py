"""Prometheus / OpenMetrics exposition linter.

The port's copy of ``semantic_router_tpu.observability.metrics_lint``: a
grammar check over a ``/metrics`` (or ``/metrics/fleet``) exposition in
either format, so a series whose exposition would break a strict
scraper, and blank every dashboard panel reading it, fails a test:

- every sample belongs to a family declared by a ``# TYPE`` line, and a
  family is declared at most once;
- ``# HELP`` pairs with its family's TYPE (HELP without samples is fine;
  duplicate HELP is not);
- histogram bucket counts are cumulative (non-decreasing with ``le``),
  terminate at ``+Inf``, and ``+Inf`` equals ``_count``;
- OpenMetrics only: counter families must NOT carry the ``_total``
  suffix (their samples must), exemplar clauses are well-formed, and the
  exposition ends with ``# EOF``;
- classic 0.0.4 only: exemplar clauses (``# {...}``) are illegal
  anywhere.
"""

from __future__ import annotations

import re
from typing import Dict, List, Tuple

_SAMPLE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?P<labels>\{[^}]*\})?\s+"
    r"(?P<value>[^ #]+)"
    r"(?P<exemplar>\s+#\s+\{.*\}\s+\S+(\s+\S+)?)?\s*$")
_EXEMPLAR_RE = re.compile(
    r'^\s+#\s+\{[a-zA-Z_][a-zA-Z0-9_]*="[^"]*"'
    r'(,[a-zA-Z_][a-zA-Z0-9_]*="[^"]*")*\}\s+\S+(\s+\S+)?\s*$')
_LE_RE = re.compile(r'le="([^"]+)"')
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="([^"]*)"')

_SUFFIXES = ("_bucket", "_sum", "_count", "_total")


def _labels_key(raw: str, drop: Tuple[str, ...] = ()) -> Tuple:
    """Sorted (name, value) pairs from a label block, minus ``drop`` —
    the normalization that lets a bucket's label set match its family's
    ``_count`` sample regardless of serialization order."""
    return tuple(sorted((k, v) for k, v in _LABEL_RE.findall(raw or "")
                        if k not in drop))


def _family_of(name: str, types: Dict[str, str]) -> str:
    """Map a sample name to its declared family (histogram samples hang
    _bucket/_sum/_count off the base name; OpenMetrics counters hang
    _total)."""
    if name in types:
        return name
    for suf in _SUFFIXES:
        if name.endswith(suf) and name[: -len(suf)] in types:
            return name[: -len(suf)]
    return ""


def lint_exposition(text: str, openmetrics: bool) -> List[str]:
    """Returns a list of grammar violations (empty = clean)."""
    errors: List[str] = []
    types: Dict[str, str] = {}
    helps: Dict[str, bool] = {}
    sample_names: List[Tuple[str, str, str]] = []  # (name, labels, value)
    lines = text.split("\n")
    if lines and lines[-1] == "":
        lines.pop()
    body = list(lines)
    if openmetrics:
        if not body or body[-1].strip() != "# EOF":
            errors.append("OpenMetrics exposition must end with '# EOF'")
        else:
            body.pop()
    for i, line in enumerate(body, 1):
        if not line:
            continue
        if line.startswith("# TYPE "):
            parts = line.split(None, 3)
            if len(parts) < 4:
                errors.append(f"line {i}: malformed TYPE line: {line!r}")
                continue
            _, _, fam, kind = parts
            if fam in types:
                errors.append(f"line {i}: duplicate TYPE for {fam}")
            if kind not in ("counter", "gauge", "histogram", "summary",
                            "untyped", "unknown", "info", "stateset",
                            "gaugehistogram"):
                errors.append(f"line {i}: unknown metric kind {kind!r}")
            if openmetrics and kind == "counter" \
                    and fam.endswith("_total"):
                errors.append(
                    f"line {i}: OpenMetrics counter family {fam!r} must "
                    f"not carry the _total suffix")
            types[fam] = kind
            continue
        if line.startswith("# HELP "):
            parts = line.split(None, 3)
            if len(parts) < 3:
                errors.append(f"line {i}: malformed HELP line: {line!r}")
                continue
            fam = parts[2]
            if helps.get(fam):
                errors.append(f"line {i}: duplicate HELP for {fam}")
            helps[fam] = True
            continue
        if line.startswith("# EOF"):
            errors.append(f"line {i}: '# EOF' before the end of the "
                          f"exposition")
            continue
        if line.startswith("#"):
            continue  # free comment (legal in 0.0.4)
        m = _SAMPLE_RE.match(line)
        if not m:
            errors.append(f"line {i}: unparseable sample line: {line!r}")
            continue
        if m.group("exemplar"):
            if not openmetrics:
                errors.append(
                    f"line {i}: exemplar clause in a text/plain 0.0.4 "
                    f"exposition (illegal outside OpenMetrics)")
            elif not _EXEMPLAR_RE.match(m.group("exemplar")):
                errors.append(f"line {i}: malformed exemplar clause: "
                              f"{m.group('exemplar')!r}")
            if m.group("exemplar") and openmetrics \
                    and not m.group("name").endswith("_bucket") \
                    and not m.group("name").endswith("_total"):
                errors.append(
                    f"line {i}: exemplar on {m.group('name')!r} — only "
                    f"counter/bucket samples may carry exemplars")
        try:
            float(m.group("value"))
        except ValueError:
            errors.append(f"line {i}: non-numeric sample value "
                          f"{m.group('value')!r}")
        sample_names.append((m.group("name"), m.group("labels") or "",
                             m.group("value")))

    # HELP/TYPE pairing: HELP for families that never declare a TYPE
    for fam in helps:
        if fam not in types:
            errors.append(f"HELP without TYPE for family {fam!r}")

    # every sample must belong to a declared family
    hist_buckets: Dict[Tuple, List[Tuple[float, float]]] = {}
    hist_counts: Dict[Tuple, float] = {}
    for name, labels, value in sample_names:
        fam = _family_of(name, types)
        if not fam:
            errors.append(f"sample {name!r} has no TYPE declaration")
            continue
        kind = types[fam]
        if openmetrics and kind == "counter" \
                and not name.endswith("_total"):
            errors.append(f"OpenMetrics counter sample {name!r} must "
                          f"carry the _total suffix")
        if kind == "histogram" and name.endswith("_bucket"):
            le_m = _LE_RE.search(labels)
            if not le_m:
                errors.append(f"histogram bucket {name}{labels} missing "
                              f"le label")
                continue
            le_raw = le_m.group(1)
            le = float("inf") if le_raw in ("+Inf", "inf") \
                else float(le_raw)
            base = _labels_key(labels, drop=("le",))
            hist_buckets.setdefault((fam, base), []).append(
                (le, float(value)))
        elif kind == "histogram" and name.endswith("_count"):
            hist_counts[(fam, _labels_key(labels))] = float(value)

    # bucket monotonicity + +Inf == _count
    for (fam, base), buckets in hist_buckets.items():
        buckets.sort(key=lambda b: b[0])
        prev = -1.0
        for le, cum in buckets:
            if cum < prev:
                errors.append(
                    f"{fam}{base}: bucket counts not cumulative "
                    f"(le={le} count {cum} < previous {prev})")
            prev = cum
        if not buckets or buckets[-1][0] != float("inf"):
            errors.append(f"{fam}{base}: histogram missing +Inf bucket")
        else:
            inf_count = buckets[-1][1]
            total = hist_counts.get((fam, base))
            if total is not None and inf_count != total:
                errors.append(
                    f"{fam}{base}: +Inf bucket ({inf_count}) != _count "
                    f"({total})")
    return errors

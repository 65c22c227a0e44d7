"""Three-valued rule-tree evaluation over partially-resolved signals.

The decision engine's ``eval_rule_node`` is a two-valued fold: every
leaf is either matched or not.  The cascade evaluates the SAME trees
while some signal families are still pending device forwards, so each
node carries a third outcome — *unknown* — plus confidence BOUNDS:
the interval the node's eventual confidence must land in under every
possible resolution of the pending families.

The fold mirrors ``decision.engine.eval_rule_node`` exactly where all
children are definite (AND with no conditions → False; AND = min over
children; NOT = 1.0 / no rules; any operator other than AND/NOT = OR =
max over matched children; complexity leaves match bare rule names
against any reported level).  The dispatcher's skip proofs reduce to
interval comparisons over these results — see planner.py for how they
compose into a winner-invariance certificate.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import FrozenSet, List, Set, Tuple

from ...config.schema import RuleNode
from ...decision.engine import SignalMatches

# node status values
TRUE = 1
FALSE = 0
UNKNOWN = -1


@dataclass
class TriResult:
    """Outcome of one node under a set of unresolved families.

    ``conf_lo``/``conf_hi`` bound the confidence the node reports IF it
    ends up matched.  ``pinned`` means the node's (confidence,
    matched_rules) pair cannot move whichever way the unresolved
    families land — required of a winner before its decision can be
    certified (selection and the explain record read both)."""

    status: int
    conf_lo: float = 0.0
    conf_hi: float = 0.0
    pinned: bool = True
    matched_rules: List[str] = field(default_factory=list)


def tri_eval_node(node: RuleNode, signals: SignalMatches,
                  unresolved: FrozenSet[str] | Set[str]) -> TriResult:
    """Evaluate ``node`` with every family in ``unresolved`` treated as
    not-yet-known.  With ``unresolved`` empty this reproduces
    ``eval_rule_node`` bit-for-bit (tested property)."""
    if node.is_leaf():
        styp = node.signal_type.lower().strip()
        if styp in unresolved:
            # the family may report anything, including nothing; a
            # matched leaf's confidence defaults to 1.0 when the
            # evaluator set none, so the honest bound is [0, 1]
            return TriResult(UNKNOWN, 0.0, 1.0, pinned=False)
        if not signals.matched(styp, node.name):
            return TriResult(FALSE)
        c = signals.confidence(styp, node.name)
        return TriResult(TRUE, c, c, pinned=True,
                         matched_rules=[f"{styp}:{node.name}"])
    op = node.operator.upper()
    if op == "AND":
        if not node.conditions:
            return TriResult(FALSE)
        children = [tri_eval_node(c, signals, unresolved)
                    for c in node.conditions]
        if any(c.status == FALSE for c in children):
            return TriResult(FALSE)
        lo = min(c.conf_lo for c in children)
        hi = min(c.conf_hi for c in children)
        if all(c.status == TRUE for c in children):
            rules: List[str] = []
            for c in children:
                rules.extend(c.matched_rules)
            return TriResult(TRUE, lo, hi,
                             pinned=all(c.pinned for c in children),
                             matched_rules=rules)
        return TriResult(UNKNOWN, lo, hi, pinned=False)
    if op == "NOT":
        children = [tri_eval_node(c, signals, unresolved)
                    for c in node.conditions]
        if any(c.status == TRUE for c in children):
            return TriResult(FALSE)
        if all(c.status == FALSE for c in children):
            return TriResult(TRUE, 1.0, 1.0, pinned=True)
        # matched-ness unknown, but a matched NOT always reports
        # confidence 1.0 and no rules — those two ARE pinned
        return TriResult(UNKNOWN, 1.0, 1.0, pinned=False)
    # OR (any operator that is not AND/NOT, matching eval_rule_node)
    children = [tri_eval_node(c, signals, unresolved)
                for c in node.conditions]
    true_children = [c for c in children if c.status == TRUE]
    open_children = [c for c in children if c.status != FALSE]
    if not open_children:
        return TriResult(FALSE)
    hi = max(c.conf_hi for c in open_children)
    if true_children:
        lo = max(c.conf_lo for c in true_children)
        if all(c.status != UNKNOWN for c in children):
            rules = []
            for c in true_children:
                rules.extend(c.matched_rules)
            return TriResult(TRUE, lo, hi,
                             pinned=all(c.pinned for c in true_children),
                             matched_rules=rules)
        # definitely matched, but an unknown sibling could still raise
        # the confidence or add rules
        return TriResult(TRUE, lo, hi, pinned=False)
    return TriResult(UNKNOWN, 0.0, hi, pinned=False)


def check_two_valued(node: RuleNode, signals: SignalMatches
                     ) -> Tuple[bool, float, List[str]]:
    """The fully-resolved fast path, returned in ``eval_rule_node``'s
    shape — used by tests to pin the tri-state fold to the engine's."""
    r = tri_eval_node(node, signals, frozenset())
    return (r.status == TRUE,
            r.conf_lo if r.status == TRUE else 0.0,
            list(r.matched_rules))

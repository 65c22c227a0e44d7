from .engine import DecisionEngine, DecisionResult, SignalMatches, \
    eval_rule_node

__all__ = ["DecisionEngine", "DecisionResult", "SignalMatches",
           "eval_rule_node"]

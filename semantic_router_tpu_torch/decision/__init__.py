from .engine import DecisionEngine, DecisionResult, SignalMatches, \
    eval_rule_node
from .projections import ProjectionEvaluator, ProjectionTrace

__all__ = ["DecisionEngine", "DecisionResult", "ProjectionEvaluator",
           "ProjectionTrace", "SignalMatches", "eval_rule_node"]

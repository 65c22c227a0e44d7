"""The data half of offline model selection: the candidate set a router
config routes to (``analyzer``) and the benchmark runner that drives
each candidate over a query set and writes the routing-benchmark corpus
``training.selection_train`` trains on (``benchmark``)."""

from .analyzer import CandidateModel, candidates_from_config
from .benchmark import BenchmarkRunner, keyword_scorer

__all__ = ["BenchmarkRunner", "keyword_scorer", "CandidateModel",
           "candidates_from_config"]

from .inflight import InflightTracker, default_tracker

__all__ = ["InflightTracker", "default_tracker"]

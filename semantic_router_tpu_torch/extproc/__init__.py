"""Envoy ExtProc gRPC filter (reference: pkg/extproc).  ``grpc`` is
imported only when an ``ExtProcServer`` is built."""

from .server import SERVICE_NAME, ExtProcServer, ExtProcService

__all__ = ["ExtProcServer", "ExtProcService", "SERVICE_NAME"]

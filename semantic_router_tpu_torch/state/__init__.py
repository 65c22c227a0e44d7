"""External state over RESP: the wire client and the embedded dev server.

The port's copy of ``semantic_router_tpu.state`` (its RESP family): the
RESP2 client, the Redis-Cluster client and their embedded servers.  Both
packages speak the same bytes on the wire and use the same keys, so a
JAX replica and a port replica on one store see one fleet.
"""

from .resp import ConnectionError_, MiniRedis, RedisClient, RespError

__all__ = ["ConnectionError_", "MiniRedis", "RedisClient", "RespError"]

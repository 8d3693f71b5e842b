"""The launcher's pieces the port has so far: the HTTP KV master
(``master.KVServer`` / ``KVClient``) that the serving fleet and the fleet
telemetry plane share."""
from .master import KVClient, KVServer

__all__ = ["KVClient", "KVServer"]

from .cache import QueryCache
from .edge import EventLoopHttpServer, WorkerPool
from .server import JsonRpcServer, JsonRpcImpl

__all__ = ["JsonRpcServer", "JsonRpcImpl", "QueryCache",
           "EventLoopHttpServer", "WorkerPool"]

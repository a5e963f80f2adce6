"""The Pro deployment's service planes: each node module's surface over
the service RPC (rpc.py), so the JSON-RPC service, executors and other
services can run in processes of their own."""

from .rpc import ServiceClient, ServiceServer  # noqa: F401
from .storage_service import RemoteStorage, StorageServer  # noqa: F401
from .executor_service import ExecutorServer, RemoteExecutor  # noqa: F401

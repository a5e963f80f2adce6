"""Node tools: the ini config loader (`config`: config.ini, genesis and
the node key of a build_chain directory), the chain builder
(`build_chain`) and the peer-median clock (`timesync`)."""

from .config import (ChainConfig, load_max_node, load_node,  # noqa: F401
                     save_node_config)
from .timesync import NodeTimeMaintenance

__all__ = ["ChainConfig", "NodeTimeMaintenance", "load_max_node", "load_node",
           "save_node_config"]

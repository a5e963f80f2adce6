from .lightnode import (  # noqa: F401
    LightNodeClient,
    LightNodeServer,
    Pruned,
    RESP_MISSING,
    RESP_OK,
    RESP_PRUNED,
)

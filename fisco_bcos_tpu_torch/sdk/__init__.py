from .client import SdkClient, TransactionBuilder

__all__ = ["SdkClient", "TransactionBuilder"]

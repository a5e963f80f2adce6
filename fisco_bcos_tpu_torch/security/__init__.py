from .dataencrypt import DataEncryption, EncryptedStorage, KeyCenter  # noqa: F401

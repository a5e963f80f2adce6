"""Host-side crypto: pure-Python oracle and the batch-native suite."""

"""Runtime auditors of the port (``runtime.py``)."""

"""The in-pod runtime of the port."""

"""Runnable workloads of the port (twins of the repository's ``examples/``)."""

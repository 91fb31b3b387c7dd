"""Observability for the port: spans (trace.py) and counters (metrics.py)."""

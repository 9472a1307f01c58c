"""Observability of the port (the metrics registry in the serving slice)."""

"""Operators of the port: paged KV-cache ops and hand-written kernels."""

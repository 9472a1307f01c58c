"""Distributed training for the port (fleet on one process only, so far)."""

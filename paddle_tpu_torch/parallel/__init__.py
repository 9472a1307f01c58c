"""Parallel training for the port: gradient bucketing and ZeRO stages 0-3
on one process (`zero`), and the one transform they use (`transforms`)."""

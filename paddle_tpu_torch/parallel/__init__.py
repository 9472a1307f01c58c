"""Parallel training for the port: gradient bucketing and ZeRO stages 0-3,
on one process and across processes (`zero`), the data-parallel mesh
(`mesh`), and the one program transform the bucket pass uses
(`transforms`)."""

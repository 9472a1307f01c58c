"""Parallel training for the port: gradient bucketing and ZeRO stages 0-3,
on one process and across processes (`zero`), the dp x pp mesh (`mesh`,
`spmd`), the pipeline runner (`pipeline`), and the program transforms:
layer scan, recompute, gradient merge (`transforms`)."""

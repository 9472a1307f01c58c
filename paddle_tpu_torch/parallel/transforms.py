"""Program transforms (counterpart of paddle_tpu/parallel/transforms.py):
only `sink_op_to_producers` (:174), which the gradient-bucket pass
(parallel/zero.py) uses. Recompute, layer scan, gradient merge and the
pipeline transforms are not ported (ROADMAP)."""
from __future__ import annotations


def sink_op_to_producers(block, op) -> int:
    """Move `op` EARLIER in the block's op list, to right after the last op
    it has a dataflow edge with: an op writing any of its inputs, or
    reading/writing any of its outputs. A bucket's sync/update op placed at
    the backward->optimize boundary sinks back to its bucket's ready point,
    the moment its last gradient is produced. The motion never crosses a
    producer of an input, a reader of an output, or another writer of an
    output, so the program computes the same values. Returns the new
    index."""
    ops = block.ops
    pos = ops.index(op)
    ins = {n for n in op.input_names() if n != "@EMPTY@"}
    outs = {n for n in op.output_names() if n != "@EMPTY@"}
    new = pos
    for i in range(pos - 1, -1, -1):
        other = ops[i]
        o_out = set(other.output_names())
        if (o_out & ins) or (o_out & outs) \
                or (set(other.input_names()) & outs):
            break
        new = i
    if new < pos:
        ops.pop(pos)
        ops.insert(new, op)
        block.program.bump_version()
    return new

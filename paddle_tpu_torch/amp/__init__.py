"""paddle.amp for the port: the static-graph autocast lists (bfloat16)."""
from .auto_cast import black_list, keep_f32_slots, white_list

__all__ = ["white_list", "black_list", "keep_f32_slots"]

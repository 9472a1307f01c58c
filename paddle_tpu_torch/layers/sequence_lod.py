"""Sequence (LoD) layer functions (counterpart of
paddle_tpu/layers/sequence_lod.py). Sequences are padded-dense [batch,
max_len, ...] plus an int32 length vector: every function here takes an
optional `length=` Variable (omitted: every row full length). Lowerings
in ops/sequence_ops.py.
"""
from __future__ import annotations

from ..framework.dtype import dtype_name
from ..layer_helper import LayerHelper

__all__ = [
    "sequence_mask", "sequence_pool", "sequence_softmax", "sequence_reverse",
    "sequence_expand_as", "sequence_pad", "sequence_unpad", "sequence_concat",
    "sequence_conv", "sequence_first_step", "sequence_last_step",
]


def _seq_inputs(x, length):
    ins = {"X": [x]}
    if length is not None:
        ins["SeqLen"] = [length]
    return ins


def sequence_mask(x, maxlen=None, dtype="int64", name=None):
    """x: lengths [b]; returns the [b, maxlen] validity mask (maxlen must
    be static)."""
    if maxlen is None:
        raise ValueError(
            "sequence_mask needs a static maxlen= (shapes are static; "
            "Paddle derives it from the LoD at run time)")
    helper = LayerHelper("sequence_mask")
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op("sequence_mask", inputs={"X": [x]},
                     outputs={"Y": [out]},
                     attrs={"maxlen": int(maxlen), "out_dtype": dtype})
    return out


def sequence_pool(input, pool_type, is_test=False, pad_value=0.0, length=None):
    helper = LayerHelper("sequence_pool")
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("sequence_pool", inputs=_seq_inputs(input, length),
                     outputs={"Out": [out]},
                     attrs={"pool_type": pool_type,
                            "pad_value": float(pad_value)})
    return out


def sequence_first_step(input, length=None):
    return sequence_pool(input, "first", length=length)


def sequence_last_step(input, length=None):
    return sequence_pool(input, "last", length=length)


def sequence_softmax(input, use_cudnn=False, name=None, length=None):
    helper = LayerHelper("sequence_softmax")
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("sequence_softmax", inputs=_seq_inputs(input, length),
                     outputs={"Out": [out]})
    return out


def sequence_reverse(x, name=None, length=None):
    helper = LayerHelper("sequence_reverse")
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("sequence_reverse", inputs=_seq_inputs(x, length),
                     outputs={"Y": [out]})
    return out


def sequence_expand_as(x, y, name=None, length=None):
    helper = LayerHelper("sequence_expand_as")
    out = helper.create_variable_for_type_inference(x.dtype)
    ins = {"X": [x], "Y": [y]}
    if length is not None:
        ins["SeqLen"] = [length]
    helper.append_op("sequence_expand_as", inputs=ins,
                     outputs={"Out": [out]})
    return out


def sequence_pad(x, pad_value=None, maxlen=None, name=None, length=None):
    """Returns (padded, lengths). The padded-dense data is already
    rectangular: this sets the padding values and surfaces the length
    tensor."""
    helper = LayerHelper("sequence_pad")
    out = helper.create_variable_for_type_inference(x.dtype)
    length_out = helper.create_variable_for_type_inference("int32")
    ins = _seq_inputs(x, length)
    if pad_value is not None:
        ins["PadValue"] = [pad_value]
    helper.append_op("sequence_pad", inputs=ins,
                     outputs={"Out": [out], "Length": [length_out]})
    return out, length_out


def sequence_unpad(x, length, name=None):
    helper = LayerHelper("sequence_unpad")
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("sequence_unpad",
                     inputs={"X": [x], "Length": [length]},
                     outputs={"Out": [out]})
    return out


def sequence_concat(input, name=None, lengths=None):
    """Concat along time, splicing the valid prefixes. Returns the
    concatenated padded tensor; a row's length is the sum of its input
    lengths."""
    helper = LayerHelper("sequence_concat")
    out = helper.create_variable_for_type_inference(input[0].dtype)
    length_out = helper.create_variable_for_type_inference("int32")
    ins = {"X": list(input)}
    if lengths is not None:
        ins["SeqLens"] = list(lengths)
    helper.append_op("sequence_concat", inputs=ins,
                     outputs={"Out": [out], "Length": [length_out]})
    return out


def sequence_conv(input, num_filters, filter_size=3, filter_stride=1,
                  padding=True, padding_start=None, bias_attr=None,
                  param_attr=None, act=None, name=None, length=None):
    assert filter_stride == 1, (
        "sequence_conv supports filter_stride=1 only (as Paddle's "
        "sequence_conv_op.cc)")
    helper = LayerHelper("sequence_conv")
    d = int(input.shape[-1])
    filt = helper.create_parameter(param_attr, [filter_size * d, num_filters],
                                   dtype=dtype_name(input.dtype))
    out = helper.create_variable_for_type_inference(input.dtype)
    ins = _seq_inputs(input, length)
    ins["Filter"] = [filt]
    helper.append_op("sequence_conv", inputs=ins, outputs={"Out": [out]},
                     attrs={"context_length": int(filter_size),
                            "context_start": padding_start,
                            "context_stride": int(filter_stride)})
    if bias_attr is not False:
        b = helper.create_parameter(bias_attr, [num_filters],
                                    dtype=dtype_name(input.dtype),
                                    is_bias=True)
        tmp = helper.create_variable_for_type_inference(input.dtype)
        helper.append_op("elementwise_add", inputs={"X": [out], "Y": [b]},
                         outputs={"Out": [tmp]}, attrs={"axis": -1})
        out = tmp
    return helper.append_activation(out, act)

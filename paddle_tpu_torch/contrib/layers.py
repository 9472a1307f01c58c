"""fluid.contrib.layers for the port (counterpart of
paddle_tpu/contrib/layers.py): tdm_child, tdm_sampler,
search_pyramid_hash, var_conv_2d, rank_attention, correlation,
bilateral_slice and similarity_focus over the dense tail's ops
(ops/dense_tail_ops2.py). As in the reference, the TDM tree tables are
Variables the caller passes (`tree_info=`, `travel=`, `layer=`)."""
from __future__ import annotations

from .. import initializer as I
from ..layer_helper import LayerHelper


def _op(op_type, inputs, out_slots, attrs=None, dtypes=None):
    helper = LayerHelper(op_type)
    outs = {}
    for s in out_slots:
        outs[s] = helper.create_variable_for_type_inference(
            (dtypes or {}).get(s, "float32"))
    helper.append_op(op_type, inputs=inputs,
                     outputs={k: [v] for k, v in outs.items()},
                     attrs=attrs or {})
    return outs


def tdm_child(x, node_nums, child_nums, param_attr=None, dtype="int32",
              tree_info=None, name=None):
    """Each node's children and which of them are items, from the
    [node_nums, 3 + child_nums] tree table `tree_info`."""
    assert tree_info is not None, \
        "pass tree_info= (the [node_nums, 3+child_nums] tree table var)"
    outs = _op("tdm_child", {"X": [x], "TreeInfo": [tree_info]},
               ("Child", "LeafMask"), {"child_nums": int(child_nums)},
               dtypes={"Child": dtype, "LeafMask": dtype})
    return outs["Child"], outs["LeafMask"]


def tdm_sampler(x, neg_samples_num_list, layer_node_num_list, leaf_node_num,
                travel=None, layer=None, output_positive=True,
                output_list=True, seed=0, tree_travel_attr=None,
                tree_layer_attr=None, dtype="int32", name=None):
    """Per item and tree layer, the positive node of its `travel` path and
    drawn negatives from that layer of `layer`; returns (nodes, labels,
    mask)."""
    assert travel is not None and layer is not None, \
        "pass travel= and layer= table Variables"
    offsets = [0]
    for n in layer_node_num_list:
        offsets.append(offsets[-1] + int(n))
    outs = _op("tdm_sampler", {"X": [x], "Travel": [travel],
                               "Layer": [layer]},
               ("Out", "Labels", "Mask"),
               {"neg_samples_num_list": [int(v) for v in
                                         neg_samples_num_list],
                "layer_offset_lod": offsets,
                "output_positive": bool(output_positive), "seed": int(seed)},
               dtypes={"Out": dtype, "Labels": dtype, "Mask": dtype})
    return outs["Out"], outs["Labels"], outs["Mask"]


def search_pyramid_hash(input, num_emb, space_len, pyramid_layer, rand_len,
                        drop_out_percent, is_training, use_filter,
                        white_list_len, black_list_len, seed,
                        lr=1.0, param_attr=None, param_attr_wl=None,
                        param_attr_bl=None, name=None,
                        distribute_update_vars=None, dtype="float32",
                        seq_len=None):
    """The summed embeddings of a sequence's hashed n-grams (the
    pyramid_hash op) over padded ids and optional `seq_len` lengths; W is
    [space_len, num_emb], uniform in +-0.1."""
    helper = LayerHelper("pyramid_hash")
    w = helper.create_parameter(param_attr, [int(space_len), int(num_emb)],
                                dtype=dtype,
                                default_initializer=I.Uniform(-0.1, 0.1))
    ins = {"X": [input], "W": [w]}
    if seq_len is not None:
        ins["SeqLen"] = [seq_len]
    outs = _op("pyramid_hash", ins, ("Out",),
               {"num_emb": int(num_emb), "space_len": int(space_len),
                "pyramid_layer": int(pyramid_layer),
                "rand_len": int(rand_len),
                "drop_out_percent": float(drop_out_percent),
                "is_training": int(is_training),
                "use_filter": bool(use_filter),
                "white_list_len": int(white_list_len),
                "black_list_len": int(black_list_len), "seed": int(seed)})
    return outs["Out"]


def var_conv_2d(input, row, col, input_channel, output_channel, filter_size,
                stride=1, param_attr=None, act=None, dtype="float32",
                name=None):
    """A per-sample variable-size convolution over padded maps with
    their `row` / `col` sizes; W [output_channel, input_channel * kh * kw]
    is Xavier."""
    helper = LayerHelper("var_conv_2d")
    fh, fw = (filter_size if hasattr(filter_size, "__len__")
              else (filter_size, filter_size))
    sh, sw = (stride if hasattr(stride, "__len__") else (stride, stride))
    w = helper.create_parameter(
        param_attr, [int(output_channel), int(input_channel * fh * fw)],
        dtype=dtype, default_initializer=I.Xavier())
    outs = _op("var_conv_2d",
               {"X": [input], "ROW": [row], "COLUMN": [col], "W": [w]},
               ("Out", "Col"),
               {"InputChannel": int(input_channel),
                "OutputChannel": int(output_channel),
                "KernelH": int(fh), "KernelW": int(fw),
                "StrideH": int(sh), "StrideW": int(sw)})
    return helper.append_activation(outs["Out"], act)


def rank_attention(input, rank_offset, rank_param_shape, rank_param_attr,
                   max_rank=3, max_size=0):
    """The rank-pair attention product of `input` by a [rank_param_shape]
    parameter (Xavier)."""
    helper = LayerHelper("rank_attention")
    w = helper.create_parameter(rank_param_attr,
                                [int(d) for d in rank_param_shape],
                                dtype="float32",
                                default_initializer=I.Xavier())
    outs = _op("rank_attention",
               {"X": [input], "RankOffset": [rank_offset],
                "RankParam": [w]},
               ("Out", "InputHelp", "InsRank"),
               {"MaxRank": int(max_rank), "MaxSize": int(max_size)})
    return outs["Out"]


def correlation(x, y, pad_size, kernel_size, max_displacement, stride1,
                stride2, corr_type_multiply=1):
    """FlowNet's cost volume of two maps."""
    outs = _op("correlation", {"Input1": [x], "Input2": [y]}, ("Output",),
               {"pad_size": int(pad_size), "kernel_size": int(kernel_size),
                "max_displacement": int(max_displacement),
                "stride1": int(stride1), "stride2": int(stride2),
                "corr_type_multiply": int(corr_type_multiply)})
    return outs["Output"]


def bilateral_slice(x, guide, grid, has_offset=False, name=None):
    """HDRNet's slice of the bilateral `grid` at (x, y, `guide`), applied
    to `x`."""
    outs = _op("bilateral_slice",
               {"X": [x], "Guide": [guide], "Grid": [grid]}, ("Out",),
               {"has_offset": bool(has_offset)})
    return outs["Out"]


def similarity_focus(input, axis, indexes, name=None):
    """The greedy similarity-focus mask of `input` along `axis`."""
    outs = _op("similarity_focus", {"X": [input]}, ("Out",),
               {"axis": int(axis), "indexes": [int(i) for i in indexes]})
    return outs["Out"]

"""Inputs for the dense tail and the CRF (paddle_tpu_torch/ops/
dense_tail_ops.py, dense_tail_ops2.py and decode_ops.py), shared by
tests/test_torch_dense_tail_ops.py (the port against the JAX reference on
the CPU) and chip_smoke.py's phase 21 (the port on the card against the
port on the CPU). numpy only: nothing here imports JAX or either package.

* `dense_tail_cases()`: {case: (inputs, attrs)} at small shapes from a
  numpy seed, one case per op type and more arms of some (`<op>:<arm>`);
  ints are int32, as the device holds them. Inputs hold what the ports
  write out by hand: tokens near 2**31 for `pyramid_hash`, ROIs and
  samples past the image's edge, tied values for `similarity_focus`, tied
  scores and a difficult box for `detection_map`, tied emissions for
  `crf_decoding`, empty refs for `edit_distance`.
* `RANDOM`: the cases whose outputs are draws (the packages draw from
  different generators: their properties are held, not their values).
  `pyramid_hash` outside training and `seed` with its attribute set draw
  nothing, and are held value for value.
* `VJP_CASES`: the cases whose pullback is held too.
* The book's semantic role labeller (`srl`, `srl_feed`) at its published
  hyperparameters, shared by the tests (at a small size) and phase 21.
"""
import math

import numpy as np

# the reference files' types this slice covers, the CRF pair included
CRF_TYPES = ("linear_chain_crf", "crf_decoding")


def op_of(case):
    return case.split(":")[0]


def _gt_and_detections(rng, b, g, k, classes):
    """Ground-truth boxes [b, g, 6] (label, difficult, x1, y1, x2, y2; the
    last of the first image zero-area padding) and detections [b, k, 6]
    (label, score, box; the last of each image padding, label -1): jittered
    copies of the truth, one of another class, and tied scores."""
    gt = np.zeros((b, g, 6), np.float32)
    det = np.zeros((b, k, 6), np.float32)
    for i in range(b):
        for j in range(g):
            x1, y1 = rng.uniform(0, 6, 2)
            w, h = rng.uniform(2, 4, 2)
            gt[i, j] = [rng.randint(0, classes), float(j == 1), x1, y1,
                        x1 + w, y1 + h]
        for j in range(k - 1):
            src = gt[i, j % g]
            jit = rng.uniform(-0.6, 0.6, 4)
            det[i, j] = [src[0] if j != 2 else (src[0] + 1) % classes,
                         round(rng.uniform(0.1, 0.9), 1), *(src[2:] + jit)]
        det[i, k - 1] = [-1, 0, 0, 0, 0, 0]
    gt[0, g - 1, 2:] = [1, 1, 1, 1]
    return det, gt


def dense_tail_cases():
    rng = np.random.RandomState(24)
    f = lambda *s: rng.randn(*s).astype(np.float32)  # noqa: E731
    i32 = lambda lo, hi, *s: rng.randint(lo, hi, s).astype(np.int32)  # noqa
    unit = lambda lo, hi, *s: rng.uniform(lo, hi, s).astype(np.float32)  # noqa

    def i32v(*v):
        return np.array(v, np.int32)

    def f32v(*v):
        return np.array(v, np.float32)

    probs = np.abs(f(3, 6)) + 0.05
    probs[1, 2] = 0.0
    tree = i32v(0, 0, 0, 1, 2,      # node 0: the root's slot, no item
                0, 1, 0, 3, 4,      # 1: children 3, 4
                0, 1, 0, 5, 6,      # 2: children 5, 6
                7, 2, 1, 0, 0,      # 3: item 7, no children
                8, 2, 1, 0, 0,      # 4
                9, 2, 2, 0, 0,      # 5
                0, 2, 2, 7, 0,      # 6: an inner node with one child
                10, 3, 6, 0, 0).reshape(8, 5)
    travel = i32v(1, 3, 1, 4, 2, 5, 2, 0, 0, 0).reshape(5, 2)
    layer = i32v(1, 2, 3, 4, 5, 6)
    tokens = i32v(2 ** 31 - 1, -2 ** 31, -1, 7, 2 ** 31 - 2, 0,
                  5, 5, 9, -7, 123456789, 3,
                  1, 2, 3, 4, 5, 6).reshape(3, 6)
    rank_off = np.zeros((5, 7), np.int32)
    for n in range(5):
        rank_off[n, 0] = rng.randint(0, 4)
        for kk in range(3):
            rank_off[n, 1 + 2 * kk] = rng.randint(0, 4)
            rank_off[n, 2 + 2 * kk] = rng.randint(0, 5)
    det, gt = _gt_and_detections(rng, 2, 3, 6, 3)
    sim = rng.randint(0, 4, (2, 3, 4, 5)).astype(np.float32)
    crf_em, crf_tr = f(3, 5, 4), f(6, 4) * 0.5
    crf_len = i32v(5, 1, 3)
    crf_lab = i32(0, 4, 3, 5)
    rois = f32v(0, 0, 6, 5, 2, 1, 8, 8, -2, 3, 11, 12).reshape(3, 4)
    # an earlier batch's accumulated lists: a live entry is a true or a
    # false positive at its score, a dead one -1 in both
    prev_score, prev_flag = unit(0, 1, 3, 4), i32(-1, 2, 3, 4)
    prev_tp = np.stack([prev_score, prev_flag], -1).astype(np.float32)
    prev_fp = np.stack([prev_score, np.where(prev_flag < 0, -1,
                                             1 - prev_flag)],
                       -1).astype(np.float32)

    c = {
        # ---- dense_tail_ops.py
        "hierarchical_sigmoid": (
            {"X": [f(6, 5)], "W": [f(5, 5)], "Label": [i32(0, 6, 6, 1)],
             "Bias": [f(5)]}, {"num_classes": 6}),
        "hierarchical_sigmoid:custom": (
            {"X": [f(4, 5)], "W": [f(9, 5)],
             "Label": [i32(0, 6, 4, 1)],
             "PathTable": [i32v(0, 2, 5, 0, 1, -1, 0, 2, 8,
                                0, -1, -1).reshape(4, 3)],
             "PathCode": [i32v(1, 0, 1, 0, 1, 0, 1, 1, 0,
                               1, 0, 0).reshape(4, 3)]},
            {"num_classes": 6}),
        "edit_distance": (
            {"Hyps": [i32(0, 4, 4, 7)], "Refs": [i32(0, 4, 4, 6)],
             "HypsLength": [i32v(7, 3, 0, 5)],
             "RefsLength": [i32v(6, 4, 2, 0)]}, {"normalized": True}),
        "edit_distance:raw": (
            {"Hyps": [i32(0, 3, 3, 5)], "Refs": [i32(0, 3, 3, 8)]},
            {"normalized": False}),
        "ctc_align": (
            {"Input": [i32v(0, 1, 1, 0, 2, 2, 3, 0,
                            2, 2, 2, 0, 0, 1, 0, 1,
                            1, 0, 3, 3, 1, 1, 0, 2).reshape(3, 8)],
             "InputLength": [i32v(8, 6, 5).reshape(3, 1)]},
            {"blank": 0, "merge_repeated": True, "padding_value": -1}),
        "ctc_align:keep_repeats": (
            {"Input": [i32(0, 3, 2, 7)]},
            {"blank": 1, "merge_repeated": False, "padding_value": 0}),
        "multinomial": ({"X": [probs]},
                        {"num_samples": 4, "replacement": True}),
        "multinomial:no_replacement": ({"X": [probs]},
                                       {"num_samples": 3,
                                        "replacement": False}),
        "histogram": ({"X": [f(50)]}, {"bins": 7, "min": 0, "max": 0}),
        "histogram:range": ({"X": [f(40)]},
                            {"bins": 5, "min": -1.0, "max": 1.0}),
        "seed": ({}, {"seed": 0}),
        "seed:fixed": ({}, {"seed": 7}),
        "bilinear_tensor_product": (
            {"X": [f(4, 3)], "Y": [f(4, 5)], "Weight": [f(2, 3, 5)],
             "Bias": [f(1, 2)]}, {}),
        "add_position_encoding": ({"X": [f(2, 5, 6)]},
                                  {"alpha": 0.7, "beta": 1.3}),
        "add_position_encoding:odd": ({"X": [f(2, 4, 5)]},
                                      {"alpha": 1.0, "beta": 1.0}),
        "squared_l2_distance": ({"X": [f(4, 5)], "Y": [f(1, 5)]}, {}),
        "squared_l2_distance:rows": ({"X": [f(3, 4)], "Y": [f(3, 4)]}, {}),
        "modified_huber_loss": (
            {"X": [f32v(2.3, 0.4, -0.3, -2.1, 1.7, -0.8, 0.05, -1.6)
                   .reshape(8, 1)],
             "Y": [f32v(1, 1, 1, 1, 0, 0, 0, 0).reshape(8, 1)]}, {}),
        "grad_add": ({"X": [f(3, 4)], "Y": [f(3, 4)]}, {}),
        "fill_zeros_like2": ({"X": [f(3, 4)]}, {"dtype": "float32"}),
        "fill_zeros_like2:int64": ({"X": [f(2, 3)]}, {"dtype": "int64"}),
        # ---- dense_tail_ops2.py
        "spp": ({"X": [f(2, 3, 7, 5)]},
                {"pyramid_height": 3, "pooling_type": "max"}),
        "spp:avg": ({"X": [f(2, 2, 6, 6)]},
                    {"pyramid_height": 2, "pooling_type": "avg"}),
        "similarity_focus": ({"X": [sim]}, {"axis": 1, "indexes": [0, 2]}),
        "similarity_focus:axis3": ({"X": [f(2, 3, 4, 5)]},
                                   {"axis": 3, "indexes": [1]}),
        "correlation": (
            {"Input1": [f(2, 3, 8, 8)], "Input2": [f(2, 3, 8, 8)]},
            {"pad_size": 2, "kernel_size": 3, "max_displacement": 2,
             "stride1": 1, "stride2": 1, "corr_type_multiply": 1}),
        "correlation:strided": (
            {"Input1": [f(1, 2, 9, 7)], "Input2": [f(1, 2, 9, 7)]},
            {"pad_size": 1, "kernel_size": 2, "max_displacement": 2,
             "stride1": 2, "stride2": 2, "corr_type_multiply": 1}),
        "bilateral_slice": (
            {"X": [f(2, 2, 6, 5)], "Grid": [f(2, 6, 4, 3, 3)],
             "Guide": [unit(0.02, 0.98, 2, 6, 5)]}, {"has_offset": False}),
        "bilateral_slice:offset": (
            {"X": [f(1, 2, 5, 4)], "Grid": [f(1, 9, 3, 4, 2)],
             "Guide": [unit(0.02, 0.98, 1, 5, 4)]}, {"has_offset": True}),
        "deformable_psroi_pooling": (
            {"Input": [f(2, 4, 9, 9)], "ROIs": [rois],
             "RoisNum": [i32v(2, 1)], "Trans": [f(3, 2, 1, 2)]},
            {"no_trans": False, "spatial_scale": 0.8, "output_dim": 2,
             "group_size": [1, 2], "pooled_height": 1, "pooled_width": 2,
             "part_size": [1, 2], "sample_per_part": 2, "trans_std": 0.1}),
        "deformable_psroi_pooling:no_trans": (
            {"Input": [f(1, 3, 7, 6)], "ROIs": [rois[:2]]},
            {"no_trans": True, "spatial_scale": 1.0, "output_dim": 3,
             "group_size": [1, 1], "pooled_height": 2, "pooled_width": 1,
             "sample_per_part": 3, "trans_std": 0.1}),
        "tdm_child": ({"X": [i32v(0, 1, 2, 3, 6, 7).reshape(3, 2)],
                       "TreeInfo": [tree]}, {"child_nums": 2}),
        "tdm_sampler": (
            {"X": [i32v(0, 1, 2, 3, 4).reshape(5, 1)], "Travel": [travel],
             "Layer": [layer]},
            {"neg_samples_num_list": [1, 2], "layer_offset_lod": [0, 2, 6],
             "output_positive": True}),
        "tdm_sampler:negatives_only": (
            {"X": [i32v(1, 2).reshape(2, 1)], "Travel": [travel],
             "Layer": [layer]},
            {"neg_samples_num_list": [1, 3], "layer_offset_lod": [0, 2, 6],
             "output_positive": False}),
        "pyramid_hash": (
            {"X": [tokens], "W": [f(40, 4)], "SeqLen": [i32v(6, 4, 1)]},
            {"num_emb": 4, "space_len": 40, "pyramid_layer": 3,
             "drop_out_percent": 0.0, "is_training": 0}),
        "pyramid_hash:training": (
            {"X": [tokens], "W": [f(40, 4)]},
            {"num_emb": 4, "space_len": 40, "pyramid_layer": 4,
             "drop_out_percent": 0.3, "is_training": 1}),
        "var_conv_2d": (
            {"X": [f(2, 2, 4, 5)], "ROW": [i32v(4, 3)],
             "COLUMN": [i32v(5, 2)], "W": [f(3, 18)]},
            {"InputChannel": 2, "OutputChannel": 3, "KernelH": 3,
             "KernelW": 3, "StrideH": 1, "StrideW": 1}),
        "var_conv_2d:strided": (
            {"X": [f(2, 1, 7, 6)], "ROW": [i32v(7, 3)],
             "COLUMN": [i32v(2, 6)], "W": [f(2, 6)]},
            {"InputChannel": 1, "OutputChannel": 2, "KernelH": 2,
             "KernelW": 3, "StrideH": 2, "StrideW": 2}),
        "rank_attention": (
            {"X": [f(5, 3)], "RankOffset": [rank_off],
             "RankParam": [f(27, 4)]}, {"MaxRank": 3, "MaxSize": 0}),
        "detection_map": (
            {"DetectRes": [det], "Label": [gt]},
            {"class_num": 3, "overlap_threshold": 0.5,
             "evaluate_difficult": False, "ap_type": "integral"}),
        "detection_map:11point_accumulated": (
            {"DetectRes": [det], "Label": [gt],
             "PosCount": [f32v(2, 1, 3)],
             "TruePos": [prev_tp], "FalsePos": [prev_fp]},
            {"class_num": 3, "overlap_threshold": 0.3,
             "evaluate_difficult": True, "ap_type": "11point"}),
        "fc": ({"Input": [f(2, 3, 4)], "W": [f(12, 5)], "Bias": [f(5)]},
               {"in_num_col_dims": 1, "activation_type": "relu"}),
        "fc:padded": ({"Input": [f(2, 3, 4)], "W": [f(8, 10)]},
                      {"in_num_col_dims": 2, "padding_weights": True}),
        # ---- decode_ops.py, the CRF pair
        "linear_chain_crf": (
            {"Emission": [crf_em], "Transition": [crf_tr],
             "Label": [crf_lab], "SeqLen": [crf_len]}, {}),
        "linear_chain_crf:full_length": (
            {"Emission": [f(2, 4, 3)], "Transition": [f(5, 3)],
             "Label": [i32(0, 3, 2, 4, 1)]}, {}),
        "crf_decoding": (
            {"Emission": [crf_em], "Transition": [crf_tr],
             "SeqLen": [crf_len]}, {}),
        "crf_decoding:label": (
            {"Emission": [crf_em], "Transition": [crf_tr],
             "Label": [crf_lab], "SeqLen": [crf_len]}, {}),
        "crf_decoding:ties": (
            {"Emission": [np.zeros((2, 5, 4), np.float32)],
             "Transition": [np.full((6, 4), 0.25, np.float32)],
             "SeqLen": [i32v(5, 3)]}, {}),
    }
    return c


RANDOM = {"multinomial", "multinomial:no_replacement", "seed",
          "tdm_sampler", "tdm_sampler:negatives_only",
          "pyramid_hash:training"}

VJP_CASES = {"hierarchical_sigmoid", "hierarchical_sigmoid:custom",
             "bilinear_tensor_product", "add_position_encoding",
             "squared_l2_distance", "modified_huber_loss", "grad_add",
             "spp", "spp:avg", "correlation", "correlation:strided",
             "bilateral_slice", "bilateral_slice:offset",
             "deformable_psroi_pooling", "pyramid_hash", "var_conv_2d",
             "var_conv_2d:strided", "rank_attention", "fc", "fc:padded",
             "linear_chain_crf", "linear_chain_crf:full_length"}


# --------------------------------------------------------------------------
# the book's semantic role labeller
# --------------------------------------------------------------------------

# the dictionary sizes `conll05.get_dict()` gives the book
# (test_label_semantic_roles.py: word_dict_len, pred_dict_len); the
# dictionaries are not in the repository, so only their sizes are used
CONLL05_WORDS = 44068
CONLL05_PREDICATES = 3162
# the label count of the JAX package's Conll05st (paddle_tpu/text/
# __init__.py:154)
CONLL05_LABELS = 67
# test_label_semantic_roles.py's hyperparameters
SRL_WORD_DIM = 32
SRL_MARK_DIM = 5
SRL_MARK_DICT = 2
SRL_HIDDEN = 512            # hidden_dim: each LSTM's hidden is 512 / 4
SRL_DEPTH = 8
SRL_MIX_HIDDEN_LR = 1e-3
SRL_BATCH = 10              # BATCH_SIZE
SRL_LR = (0.01, 100000, 0.5)  # exponential_decay(lr, decay_steps, rate),
#                               staircase
# Conll05st's draw of a sentence's length: numpy randint(5, 30), padded
# to its longest
SRL_MIN_LEN, SRL_MAX_LEN = 5, 29
SRL_CONTEXT = ("ctx_n2", "ctx_n1", "ctx_0", "ctx_p1", "ctx_p2")
SRL_INPUTS = ("word",) + SRL_CONTEXT + ("verb", "mark")


def srl_sizes(words=CONLL05_WORDS, predicates=CONLL05_PREDICATES,
              labels=CONLL05_LABELS):
    return {"word": words, "predicate": predicates, "label": labels}


def srl_chunk_types(labels):
    """chunk_eval's num_chunk_types for IOB labels, as the book counts
    them: ceil((labels - 1) / 2)."""
    return int(math.ceil((labels - 1) / 2.0))


def srl(L, ParamAttr, T, sizes=None, word_dim=SRL_WORD_DIM,
        mark_dim=SRL_MARK_DIM, hidden_dim=SRL_HIDDEN, depth=SRL_DEPTH,
        mix_hidden_lr=SRL_MIX_HIDDEN_LR, is_sparse=True):
    """The book's `db_lstm` (test_label_semantic_roles.py) with layers
    module `L` and its ParamAttr class, in the padded convention ([B, T]
    ids and a length vector `length`): word and the five context words
    share the frozen embedding `emb` (trainable=False), the predicate has
    `vemb`, the mark a [2, mark_dim] table, every table `is_sparse`;
    hidden_0 the sums of one fc(hidden_dim, tanh) a feature, then a
    dynamic_lstm (candidate relu, gate and cell sigmoid), then depth - 1
    layers of mix_hidden (the sums of two fc tanh) and an LSTM reversed at
    odd depths; feature_out the sums of two fc(labels, tanh); the
    linear_chain_crf with `crfw` at mix_hidden_lr, and the mean.
    Returns (loss, feature_out, target, length)."""
    sizes = sizes or srl_sizes()
    ids = {n: L.data(name=n, shape=[T], dtype="int64") for n in SRL_INPUTS}
    target = L.data(name="target", shape=[T], dtype="int64")
    length = L.data(name="length", shape=[1], dtype="int64")
    flat_len = L.reshape(length, [-1])

    def table(x, size, attr):
        e = L.embedding(L.unsqueeze(x, [2]), size=size, is_sparse=is_sparse,
                        param_attr=attr)
        return L.reshape(e, [-1, T, size[1]])

    embs = [table(ids[n], [sizes["word"], word_dim],
                  ParamAttr(name="emb", trainable=False))
            for n in ("word",) + SRL_CONTEXT]
    embs.append(table(ids["verb"], [sizes["predicate"], word_dim], "vemb"))
    embs.append(table(ids["mark"], [SRL_MARK_DICT, mark_dim], None))

    def fc(x, size):
        return L.fc(x, size, num_flatten_dims=2, act="tanh")

    hidden_0 = L.sums([fc(e, hidden_dim) for e in embs])
    lstm_0, _ = L.dynamic_lstm(hidden_0, hidden_dim,
                               candidate_activation="relu",
                               gate_activation="sigmoid",
                               cell_activation="sigmoid", length=flat_len)
    inputs = [hidden_0, lstm_0]
    for i in range(1, depth):
        mix_hidden = L.sums([fc(inputs[0], hidden_dim),
                             fc(inputs[1], hidden_dim)])
        lstm, _ = L.dynamic_lstm(mix_hidden, hidden_dim,
                                 candidate_activation="relu",
                                 gate_activation="sigmoid",
                                 cell_activation="sigmoid",
                                 is_reverse=(i % 2) == 1, length=flat_len)
        inputs = [mix_hidden, lstm]
    feature_out = L.sums([fc(inputs[0], sizes["label"]),
                          fc(inputs[1], sizes["label"])])
    crf_cost = L.linear_chain_crf(
        feature_out, target,
        param_attr=ParamAttr(name="crfw", learning_rate=mix_hidden_lr),
        length=length)
    return L.mean(crf_cost), feature_out, target, length


def srl_feed(n, batch, T=SRL_MAX_LEN, sizes=None, seed=0):
    """`n` batches from numpy `seed` as conll05's reader lays a sentence
    out: a length from Conll05st's draw, word ids uniform over the
    dictionary, the predicate at a uniform position, its id uniform over
    the predicate dictionary and repeated over the sentence, the five
    context words (the words at the predicate's offsets -2..2, 0 and 1 for
    bos / eos past the sentence) each repeated, mark 1 on the positions
    the context covers, labels uniform over the label dictionary; every
    position past the length 0."""
    sizes = sizes or srl_sizes()
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        f = {k: np.zeros((batch, T), np.int64)
             for k in SRL_INPUTS + ("target",)}
        lens = np.zeros((batch, 1), np.int64)
        for i in range(batch):
            ln = int(rng.randint(SRL_MIN_LEN, min(SRL_MAX_LEN, T) + 1))
            words = rng.randint(2, sizes["word"], ln)
            p = int(rng.randint(0, ln))
            f["word"][i, :ln] = words
            f["verb"][i, :ln] = rng.randint(0, sizes["predicate"])
            for name, off in zip(SRL_CONTEXT, range(-2, 3)):
                q = p + off
                f[name][i, :ln] = words[q] if 0 <= q < ln else \
                    (0 if q < 0 else 1)
                if 0 <= q < ln:
                    f["mark"][i, q] = 1
            f["target"][i, :ln] = rng.randint(0, sizes["label"], ln)
            lens[i, 0] = ln
        f["length"] = lens
        out.append(f)
    return out

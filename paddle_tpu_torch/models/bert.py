"""BERT/ERNIE-family encoder, static-graph builder (counterpart of
paddle_tpu/models/bert.py): `BertConfig`, `encoder_layer`, `bert_encoder`,
`bert_pretrain_loss`, `build_pretrain_program`. The program it builds is
the reference's, op for op and name for name (tests/test_torch_program.py
compares the descs). Attention is the `fused_attention` op: the flash
kernels B1-B3 on the card.

`pipeline_stages` > 1 builds the program under `device_guard` stages as
the reference does: the embeddings on stage 0, the layers in contiguous
chunks, the MLM head on the last stage.

`tp_sharding_rules()` is the reference's Megatron table with the
vocab-sharded word embedding and MLM head; with a tp mesh set before the
build, the auto-selected head stays dense where those rules vocab-shard
it (`_tp_vocab_shards_head`), as in the reference.

Not ported: MoE FFNs (a config with `moe_experts` raises, ROADMAP item
12).
"""
from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass

from .. import initializer as I
from .. import layers
from ..framework.program import device_guard
from ..layer_helper import ParamAttr


@dataclass
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position: int = 512
    type_vocab_size: int = 2
    hidden_dropout: float = 0.1
    attention_dropout: float = 0.1
    seq_len: int = 128
    sequence_parallel: bool = False
    sp_mode: str = "ring"
    moe_experts: int = 0
    moe_capacity_factor: float = 2.0
    pipeline_stages: int = 0
    # MLM head as the vocab-chunked streaming CE (ops/fused_ce.py). None =
    # auto: at sequence >= 512 with a vocabulary of at least two chunks
    fused_mlm_head: "bool | None" = None

    @staticmethod
    def base():
        return BertConfig()

    @staticmethod
    def large():
        return BertConfig(hidden_size=1024, num_layers=24, num_heads=16,
                          intermediate_size=4096)

    @staticmethod
    def tiny():
        return BertConfig(vocab_size=1024, hidden_size=64, num_layers=2,
                          num_heads=4, intermediate_size=128,
                          max_position=128, seq_len=32)


def _check_ported(cfg: BertConfig):
    if cfg.moe_experts:
        raise NotImplementedError(
            "BertConfig.moe_experts (switch_moe FFNs) is not ported yet "
            "(ROADMAP item 12)")


def _stage_guard(cfg: BertConfig):
    """device_guard factory: a no-op context when pipeline is off."""
    if cfg.pipeline_stages and cfg.pipeline_stages > 1:
        return lambda s: device_guard(f"gpu:{s}")
    return lambda s: contextlib.nullcontext()


def _layer_stage(cfg: BertConfig, i: int) -> int:
    if not cfg.pipeline_stages or cfg.pipeline_stages <= 1:
        return 0
    if cfg.pipeline_stages > cfg.num_layers:
        raise ValueError(
            f"pipeline_stages={cfg.pipeline_stages} > num_layers="
            f"{cfg.num_layers}: some pp stages would hold no ops")
    return i * cfg.pipeline_stages // cfg.num_layers


def _last_stage(cfg: BertConfig) -> int:
    return max(1, cfg.pipeline_stages or 1) - 1


def _attr(name):
    return ParamAttr(name=name, initializer=I.TruncatedNormal(0.0, 0.02))


def encoder_layer(x, cfg: BertConfig, idx: int, attn_mask=None):
    """One post-LN transformer block."""
    _check_ported(cfg)
    h, nh = cfg.hidden_size, cfg.num_heads
    hd = h // nh
    pre = x
    qkv = layers.fc(x, 3 * h, num_flatten_dims=2,
                    param_attr=_attr(f"enc{idx}_attn_qkv_w"),
                    bias_attr=ParamAttr(name=f"enc{idx}_attn_qkv_b"))
    q, k, v = layers.split(qkv, 3, dim=2)

    def heads(t):
        t = layers.reshape(t, [0, 0, nh, hd])
        return layers.transpose(t, [0, 2, 1, 3])  # [B, nh, S, hd]

    q, k, v = heads(q), heads(k), heads(v)
    ctx = layers.fused_attention(
        q, k, v, mask=attn_mask, scale=1.0 / math.sqrt(hd),
        dropout=cfg.attention_dropout,
        sequence_parallel=cfg.sequence_parallel, sp_mode=cfg.sp_mode)
    ctx = layers.transpose(ctx, [0, 2, 1, 3])
    ctx = layers.reshape(ctx, [0, 0, h])
    proj = layers.fc(ctx, h, num_flatten_dims=2,
                     param_attr=_attr(f"enc{idx}_attn_proj_w"),
                     bias_attr=ParamAttr(name=f"enc{idx}_attn_proj_b"))
    if cfg.hidden_dropout:
        proj = layers.dropout(proj, cfg.hidden_dropout,
                              dropout_implementation="upscale_in_train")
    x = layers.layer_norm(layers.elementwise_add(pre, proj),
                          begin_norm_axis=2,
                          param_attr=ParamAttr(name=f"enc{idx}_ln1_scale"),
                          bias_attr=ParamAttr(name=f"enc{idx}_ln1_bias"))
    pre = x
    ffn = layers.fc(x, cfg.intermediate_size, num_flatten_dims=2,
                    act="gelu", param_attr=_attr(f"enc{idx}_ffn_in_w"),
                    bias_attr=ParamAttr(name=f"enc{idx}_ffn_in_b"))
    ffn = layers.fc(ffn, h, num_flatten_dims=2,
                    param_attr=_attr(f"enc{idx}_ffn_out_w"),
                    bias_attr=ParamAttr(name=f"enc{idx}_ffn_out_b"))
    if cfg.hidden_dropout:
        ffn = layers.dropout(ffn, cfg.hidden_dropout,
                             dropout_implementation="upscale_in_train")
    return layers.layer_norm(layers.elementwise_add(pre, ffn),
                             begin_norm_axis=2,
                             param_attr=ParamAttr(name=f"enc{idx}_ln2_scale"),
                             bias_attr=ParamAttr(name=f"enc{idx}_ln2_bias"))


def _bert_embeddings(input_ids, cfg: BertConfig):
    word_emb = layers.embedding(
        layers.unsqueeze(input_ids, [2]), [cfg.vocab_size, cfg.hidden_size],
        param_attr=_attr("word_embedding"))
    word_emb = layers.reshape(word_emb, [0, 0, cfg.hidden_size])
    pos_emb_table = layers.create_parameter(
        [cfg.max_position, cfg.hidden_size], "float32",
        attr=_attr("pos_embedding"))
    pos_emb = layers.slice(pos_emb_table, [0], [0], [cfg.seq_len])
    pos_emb = layers.unsqueeze(pos_emb, [0])
    x = layers.elementwise_add(word_emb, pos_emb)
    x = layers.layer_norm(x, begin_norm_axis=2,
                          param_attr=ParamAttr(name="emb_ln_scale"),
                          bias_attr=ParamAttr(name="emb_ln_bias"))
    if cfg.hidden_dropout:
        x = layers.dropout(x, cfg.hidden_dropout,
                           dropout_implementation="upscale_in_train")
    return x


def bert_encoder(input_ids, cfg: BertConfig, position_ids=None,
                 attn_mask=None):
    """Embeddings + N encoder layers -> sequence output [B, S, H]."""
    _check_ported(cfg)
    stage = _stage_guard(cfg)
    with stage(0):
        x = _bert_embeddings(input_ids, cfg)
    ckpts = []
    for i in range(cfg.num_layers):
        with stage(_layer_stage(cfg, i)):
            x = encoder_layer(x, cfg, i, attn_mask)
        ckpts.append(x.name)
    x._layer_checkpoints = ckpts
    return x


def _tp_vocab_shards_head() -> bool:
    """True when the current mesh has tp > 1 and this model's tp rules
    vocab-shard `mlm_head_w` (reference :199): the fused head's chunked
    scan would then regather the sharded weight, so the auto-select keeps
    the dense head (forcing `fused_mlm_head=True` still wins). A build
    before the mesh exists is covered by fleet's `_warn_tp_fused_head`."""
    from ..parallel.mesh import get_mesh
    mesh = get_mesh()
    if mesh is None or int(mesh.shape.get("tp", 1)) <= 1:
        return False
    spec = tp_sharding_rules().spec_for("mlm_head_w")
    return any(ax == "tp" or (isinstance(ax, (tuple, list)) and "tp" in ax)
               for ax in spec)


def bert_pretrain_loss(seq_out, mlm_labels, cfg: BertConfig):
    """Masked-LM head + mean loss. The fused head (auto at S >= 512 with a
    real vocabulary, unless tp vocab-shards it) has the dense head's
    parameter names and shapes."""
    from ..ops.fused_ce import DEFAULT_CHUNK
    fused = cfg.fused_mlm_head
    if fused is None:
        fused = (cfg.seq_len >= 512 and cfg.vocab_size >= 2 * DEFAULT_CHUNK
                 and not _tp_vocab_shards_head())
    with _stage_guard(cfg)(_last_stage(cfg)):
        if fused:
            w = layers.create_parameter([cfg.hidden_size, cfg.vocab_size],
                                        "float32", attr=_attr("mlm_head_w"))
            b = layers.create_parameter([cfg.vocab_size], "float32",
                                        attr=ParamAttr(name="mlm_head_b"),
                                        is_bias=True)
            loss = layers.fused_lm_head_ce(seq_out, w, mlm_labels, bias=b,
                                           w_layout="hv")
            if cfg.fused_mlm_head is None:
                loss.block.ops[-1].attrs["auto_selected"] = True
        else:
            logits = layers.fc(seq_out, cfg.vocab_size, num_flatten_dims=2,
                               param_attr=_attr("mlm_head_w"),
                               bias_attr=ParamAttr(name="mlm_head_b"))
            loss = layers.softmax_with_cross_entropy(logits, mlm_labels)
        return layers.mean(loss)


def build_pretrain_program(cfg: BertConfig, use_input_mask=False):
    """Declare the data vars and the pretrain graph; returns (ids, labels,
    loss). With `use_input_mask`, a float `input_mask` feed (1 = token,
    0 = pad, [B, S]) becomes the additive key-padding mask [B,1,1,S] the
    attention kernels take."""
    _check_ported(cfg)
    input_ids = layers.data(name="input_ids", shape=[cfg.seq_len],
                            dtype="int64")
    mlm_labels = layers.data(name="mlm_labels", shape=[cfg.seq_len, 1],
                             dtype="int64")
    attn_mask = None
    if use_input_mask:
        input_mask = layers.data(name="input_mask", shape=[cfg.seq_len],
                                 dtype="float32")
        attn_mask = layers.unsqueeze(
            layers.scale(input_mask, scale=1e9, bias=-1e9), [1, 2])
    seq = bert_encoder(input_ids, cfg, attn_mask=attn_mask)
    loss = bert_pretrain_loss(seq, mlm_labels, cfg)
    loss._layer_checkpoints = getattr(seq, "_layer_checkpoints", [])
    return input_ids, mlm_labels, loss


def tp_sharding_rules():
    """Megatron tensor-parallel rules (reference :287): the shared
    transformer table (parallel/mesh.py `transformer_tp_rules`) with the
    vocab-sharded word embedding and MLM head first."""
    from ..parallel.mesh import P, transformer_tp_rules
    return transformer_tp_rules(extra=[
        (r"^word_embedding$", P("tp", None)),
        (r"^mlm_head_w$", P(None, "tp")),
        (r"^mlm_head_b$", P("tp")),
    ])

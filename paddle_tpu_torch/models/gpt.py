"""GPT-style causal-decoder LM, static-graph builder (counterpart of
paddle_tpu/models/gpt.py): `GPTConfig`, `decoder_layer`, `gpt_decoder`,
`build_lm_program`. Pre-LN blocks, batch-major [B, S, H], the
`fused_attention` op with `causal=True` (the flash kernels B1-B3 on the
card), tied input/output embeddings: one [V, H] table serves the token
gather and the LM head. The program it builds is the reference's, op for
op and name for name (tests/test_torch_gpt_lm.py compares the descs). The
default config is GPT-2 small.

`pipeline_stages` > 1 builds the program under `device_guard` stages as
the reference does: the embeddings on stage 0, the blocks in contiguous
chunks, the final LN and the tied head on the last stage (the pipeline
runner, parallel/pipeline.py, sums the tied `wte`'s two stages'
gradients).

`tp_sharding_rules()` is the reference's Megatron table with the tied
vocab table; `sequence_parallel` / `sp_mode` reach the `fused_attention`
op, which runs ring or Ulysses attention on an sp mesh
(ops/attention.py).
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
class GPTConfig:
    vocab_size: int = 50257
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position: int = 1024
    hidden_dropout: float = 0.1
    attention_dropout: float = 0.1
    seq_len: int = 128
    sequence_parallel: bool = False
    sp_mode: str = "ring"
    # >1: device_guard stages for pipeline parallelism over the pp mesh
    # axis (embeddings stage 0, blocks in contiguous chunks, tied head last)
    pipeline_stages: int = 0

    @staticmethod
    def small():
        return GPTConfig()

    @staticmethod
    def tiny():
        return GPTConfig(vocab_size=512, hidden_size=64, num_layers=2,
                         num_heads=4, intermediate_size=128,
                         max_position=64, seq_len=32,
                         hidden_dropout=0.0, attention_dropout=0.0)


def _attr(name):
    return ParamAttr(name=name, initializer=I.TruncatedNormal(0.0, 0.02))


def _ln(x, name):
    return layers.layer_norm(x, begin_norm_axis=2,
                             param_attr=ParamAttr(name=f"{name}_scale"),
                             bias_attr=ParamAttr(name=f"{name}_bias"))


def decoder_layer(x, cfg: GPTConfig, idx: int):
    """Pre-LN causal block (GPT-2 ordering)."""
    h, nh = cfg.hidden_size, cfg.num_heads
    hd = h // nh

    a = _ln(x, f"dec{idx}_ln1")
    qkv = layers.fc(a, 3 * h, num_flatten_dims=2,
                    param_attr=_attr(f"dec{idx}_attn_qkv_w"),
                    bias_attr=ParamAttr(name=f"dec{idx}_attn_qkv_b"))
    q, k, v = layers.split(qkv, 3, dim=2)

    def heads(t):
        t = layers.reshape(t, [0, 0, nh, hd])
        return layers.transpose(t, [0, 2, 1, 3])   # [B, nh, S, hd]

    ctx = layers.fused_attention(
        heads(q), heads(k), heads(v), causal=True,
        scale=1.0 / math.sqrt(hd), dropout=cfg.attention_dropout,
        sequence_parallel=cfg.sequence_parallel, sp_mode=cfg.sp_mode)
    ctx = layers.reshape(layers.transpose(ctx, [0, 2, 1, 3]), [0, 0, h])
    proj = layers.fc(ctx, h, num_flatten_dims=2,
                     param_attr=_attr(f"dec{idx}_attn_proj_w"),
                     bias_attr=ParamAttr(name=f"dec{idx}_attn_proj_b"))
    if cfg.hidden_dropout:
        proj = layers.dropout(proj, cfg.hidden_dropout,
                              dropout_implementation="upscale_in_train")
    x = layers.elementwise_add(x, proj)

    f = _ln(x, f"dec{idx}_ln2")
    ffn = layers.fc(f, cfg.intermediate_size, num_flatten_dims=2,
                    act="gelu", param_attr=_attr(f"dec{idx}_ffn_in_w"),
                    bias_attr=ParamAttr(name=f"dec{idx}_ffn_in_b"))
    ffn = layers.fc(ffn, h, num_flatten_dims=2,
                    param_attr=_attr(f"dec{idx}_ffn_out_w"),
                    bias_attr=ParamAttr(name=f"dec{idx}_ffn_out_b"))
    if cfg.hidden_dropout:
        ffn = layers.dropout(ffn, cfg.hidden_dropout,
                             dropout_implementation="upscale_in_train")
    return layers.elementwise_add(x, ffn)


def _stage_guard(cfg: GPTConfig):
    """device_guard factory: a no-op context when pipeline is off."""
    if cfg.pipeline_stages and cfg.pipeline_stages > 1:
        return lambda s: device_guard(f"gpu:{s}")
    return lambda s: contextlib.nullcontext()


def _layer_stage(cfg: GPTConfig, i: int) -> int:
    if not cfg.pipeline_stages or cfg.pipeline_stages <= 1:
        return 0
    if cfg.pipeline_stages > cfg.num_layers:
        raise ValueError(
            f"pipeline_stages={cfg.pipeline_stages} > num_layers="
            f"{cfg.num_layers}: some pp submeshes would hold no ops")
    return i * cfg.pipeline_stages // cfg.num_layers


def _last_stage(cfg: GPTConfig) -> int:
    return max(1, cfg.pipeline_stages or 1) - 1


def gpt_decoder(token_ids, cfg: GPTConfig):
    """Tied embeddings + N pre-LN causal blocks + final LN. Returns
    (seq_out [B, S, H], the wte var for the tied head). The per-layer
    boundary var names land on the returned var's `_layer_checkpoints`."""
    stage = _stage_guard(cfg)
    last = _last_stage(cfg)
    with stage(0):
        wte = layers.create_parameter([cfg.vocab_size, cfg.hidden_size],
                                      "float32", attr=_attr("wte"))
        wpe = layers.create_parameter([cfg.max_position, cfg.hidden_size],
                                      "float32", attr=_attr("wpe"))
        tok = layers.gather(wte, layers.reshape(token_ids, [-1]))
        tok = layers.reshape(tok, [-1, cfg.seq_len, cfg.hidden_size])
        pos = layers.unsqueeze(
            layers.slice(wpe, [0], [0], [cfg.seq_len]), [0])
        x = layers.elementwise_add(tok, pos)
        if cfg.hidden_dropout:
            x = layers.dropout(x, cfg.hidden_dropout,
                               dropout_implementation="upscale_in_train")
    ckpts = []
    for i in range(cfg.num_layers):
        with stage(_layer_stage(cfg, i)):
            x = decoder_layer(x, cfg, i)
        ckpts.append(x.name)
    with stage(last):
        out = _ln(x, "final_ln")
    out._layer_checkpoints = ckpts
    return out, wte


def build_lm_program(cfg: GPTConfig, fused_head: "bool | None" = None):
    """Next-token LM objective: predict tokens[1:] from tokens[:-1].
    Returns (tokens, loss).

    fused_head=None auto-selects: at a vocabulary of at least two 8192
    chunks the head + CE is the vocab-chunked streaming op
    (`layers.fused_lm_head_ce` on the [V, H] tied table, ops/fused_ce.py)
    that never materialises the [B, S, V] logits; smaller vocabularies keep
    the dense `matmul(..., transpose_y=True)` + softmax_with_cross_entropy
    pair. Pass True/False to force either."""
    tokens = layers.data(name="tokens", shape=[cfg.seq_len], dtype="int64")
    seq, wte = gpt_decoder(tokens, cfg)
    auto_head = fused_head is None
    if auto_head:
        from ..ops.fused_ce import DEFAULT_CHUNK
        fused_head = cfg.vocab_size >= 2 * DEFAULT_CHUNK
    with _stage_guard(cfg)(_last_stage(cfg)):
        shift_labels = layers.slice(tokens, [1], [1], [cfg.seq_len])
        shift_labels = layers.unsqueeze(shift_labels, [2])
        if fused_head:
            shift_seq = layers.slice(seq, [1], [0], [cfg.seq_len - 1])
            loss = layers.fused_lm_head_ce(shift_seq, wte, shift_labels)
            if auto_head:
                loss.block.ops[-1].attrs["auto_selected"] = True
        else:
            logits = layers.matmul(seq, wte, transpose_y=True)  # tied head
            shift_logits = layers.slice(logits, [1], [0],
                                        [cfg.seq_len - 1])
            loss = layers.softmax_with_cross_entropy(shift_logits,
                                                     shift_labels)
        mean_loss = layers.mean(loss)
        mean_loss._layer_checkpoints = getattr(seq, "_layer_checkpoints", [])
        return tokens, mean_loss


def tp_sharding_rules():
    """The shared transformer tp table and the tied vocab table (reference
    :200). GPT-2's 50257 rows do not divide by 2, so at tp 2
    `sharding_for` leaves `wte` whole on every rank, as the reference's
    does."""
    from ..parallel.mesh import P, transformer_tp_rules
    return transformer_tp_rules(extra=[(r"^wte$", P("tp", None))])

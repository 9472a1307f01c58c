"""The port's sharding rules (parallel/mesh.py `ShardingRules`,
parallel/spmd.py `DistConfig.feed_sharding`) against the reference's.

For every rule of `transformer_tp_rules`, `moe_sharding_rules` and GPT's
and BERT's `tp_sharding_rules`, at the shapes the tiny and the full
models give them (GPT-2's 50257-row `wte`, which tp 2 does not divide,
included), an `@LAYERS` stacked name of each, and a name no rule
matches: `spec_for` equals the reference's, and the spec left after the
indivisible axes are dropped equals the spec of the reference's
`sharding_for` on a jax mesh dp 2 x tp 2 x sp 2 (the test process's 8
virtual CPU devices). The port's DTensor placements follow from that
spec. `feed_sharding` is checked the same way. Exact equality."""
from types import SimpleNamespace

import numpy as np
import pytest

from paddle_tpu.models import bert as ref_bert
from paddle_tpu.models import gpt as ref_gpt
from paddle_tpu.parallel import mesh as ref_mesh
from paddle_tpu.parallel import spmd as ref_spmd
from paddle_tpu_torch.models import bert as port_bert
from paddle_tpu_torch.models import gpt as port_gpt
from paddle_tpu_torch.parallel import mesh as port_mesh
from paddle_tpu_torch.parallel import spmd as port_spmd

TABLES = {
    "transformer": (ref_mesh.transformer_tp_rules,
                    port_mesh.transformer_tp_rules),
    "moe": (ref_mesh.moe_sharding_rules, port_mesh.moe_sharding_rules),
    "gpt": (ref_gpt.tp_sharding_rules, port_gpt.tp_sharding_rules),
    "bert": (ref_bert.tp_sharding_rules, port_bert.tp_sharding_rules),
}
H, F = 768, 3072
NAMES = [
    ("dec0_attn_qkv_w", (H, 3 * H)), ("dec0_attn_qkv_b", (3 * H,)),
    ("enc3_ffn_in_w", (H, F)), ("enc3_ffn_in_b", (F,)),
    ("dec11_attn_proj_w", (H, H)), ("dec11_ffn_out_w", (F, H)),
    ("dec0_attn_proj_b", (H,)), ("dec0_ln1_scale", (H,)),
    ("wte", (50257, H)), ("wte", (512, 64)), ("wpe", (1024, H)),
    ("word_embedding", (30522, H)), ("word_embedding", (30521, H)),
    ("mlm_head_w", (H, 30522)), ("mlm_head_b", (30522,)),
    ("mlm_head_b", (30521,)), ("layer0_expert_w1", (4, H, F)),
    ("layer0_expert_b2_0", (3, H)), ("enc_attn_qkv_w", (H, 3 * H + 1)),
    ("unmatched_thing", (7, 5)),
]
CASES = [(t, n, s) for t in TABLES for n, s in NAMES] + \
    [(t, n + "@LAYERS", (12,) + s) for t in TABLES for n, s in NAMES[:6]]


@pytest.fixture(scope="module")
def jax_mesh():
    import jax
    assert jax.device_count() == 8
    return ref_mesh.build_mesh(dp=2, tp=2, sp=2)


def _spec(p):
    return tuple(tuple(a) if isinstance(a, (list, tuple)) else a
                 for a in p)


@pytest.mark.parametrize("table,name,shape", CASES)
def test_spec_and_dropped_axes_match_the_reference(jax_mesh, table, name,
                                                   shape):
    ref_rules, port_rules = (f() for f in TABLES[table])
    assert _spec(port_rules.spec_for(name, shape)) \
        == _spec(ref_rules.spec_for(name, shape))
    want = _spec(ref_rules.sharding_for(jax_mesh, name, shape).spec)
    got = _spec(port_rules.fixed_spec(dict(jax_mesh.shape), name, shape))
    # the reference's spec may be shorter than the tensor's rank
    assert got[:len(want)] == want and not any(got[len(want):])


def test_placements_follow_the_spec():
    """Shard(d) on each mesh dim a dim's spec names, Replicate elsewhere;
    axes of size 1 are not mesh dims; GPT-2's `wte` stays whole at tp 2."""
    from torch.distributed.tensor import Replicate, Shard
    rules = port_gpt.tp_sharding_rules()
    mesh = port_mesh.Mesh(2, tp=2, sp=1, device_mesh=object())
    assert mesh.mesh_axes == ("dp", "tp") and mesh.mixed
    assert rules.sharding_for(mesh, "dec0_attn_qkv_w", (H, 3 * H)) \
        == [Replicate(), Shard(1)]
    assert rules.sharding_for(mesh, "dec0_ffn_out_w", (F, H)) \
        == [Replicate(), Shard(0)]
    assert rules.sharding_for(mesh, "wte", (50257, H)) \
        == [Replicate(), Replicate()]
    assert rules.sharding_for(mesh, "dec0_attn_qkv_w@LAYERS",
                              (12, H, 3 * H)) == [Replicate(), Shard(2)]
    both = port_mesh.ShardingRules([("x", port_mesh.P(("dp", "tp")))])
    assert both.sharding_for(mesh, "x", (8,)) == [Shard(0), Shard(0)]
    assert both.sharding_for(mesh, "x", (6,)) == [Replicate(), Replicate()]


FEEDS = [("tokens", (8, 512)), ("tokens", (7, 512)), ("lr", ()),
         ("stats", (8, 3)), ("mask", (16, 1, 1, 128))]


@pytest.mark.parametrize("name,shape", FEEDS)
@pytest.mark.parametrize("axes", [("dp",), ("dp", "sp")])
def test_feed_sharding_matches_the_reference(jax_mesh, name, shape, axes):
    ref = ref_spmd.DistConfig(mesh=jax_mesh, batch_axes=axes,
                              replicated_feeds=("stats",))
    port = port_spmd.DistConfig(batch_axes=axes, replicated_feeds=("stats",))
    want = _spec(ref.feed_sharding(jax_mesh, name, shape).spec)
    got = _spec(port.feed_spec(SimpleNamespace(shape=dict(jax_mesh.shape)),
                               name, shape))
    assert got[:len(want)] == want and not any(got[len(want):])


def test_zero1_fallback_rules_match_the_reference():
    ref = ref_spmd.zero1_fallback_rules(ref_gpt.tp_sharding_rules())
    port = port_spmd.zero1_fallback_rules(port_gpt.tp_sharding_rules())
    for name in ("wte", "wte_moment1_0", "dec0_attn_qkv_w_velocity_3",
                 "dec0_attn_qkv_w", "x_mean_square_1"):
        assert _spec(port.spec_for(name)) == _spec(ref.spec_for(name))
    assert np.all([_spec(p) == _spec(r) for (_, p), (_, r) in zip(
        port_spmd.ZERO1_FALLBACK_STATE_RULES,
        ref_spmd.ZERO1_FALLBACK_STATE_RULES)])


def test_bert_auto_head_stays_dense_when_tp_vocab_shards_it():
    """`_tp_vocab_shards_head` (reference bert.py:199): with a tp 2 mesh
    set before the build, BERT at S 512 and a real vocabulary keeps the
    dense MLM head, as the reference's does; without one it fuses."""
    from paddle_tpu_torch.framework import program as pm, unique_name

    def fused():
        main, start = pm.Program(), pm.Program()
        with pm.program_guard(main, start), unique_name.guard():
            cfg = port_bert.BertConfig.tiny()
            cfg.seq_len, cfg.max_position, cfg.vocab_size = 512, 512, 30522
            port_bert.build_pretrain_program(cfg)
        return any(op.type == "fused_lm_head_ce"
                   for op in main.global_block().ops)

    assert fused()
    try:
        port_mesh.set_mesh(port_mesh.Mesh(1, tp=2, device_mesh=object()))
        assert port_bert._tp_vocab_shards_head()
        assert not fused()
    finally:
        port_mesh.set_mesh(None)


def test_warn_tp_fused_head_reads_the_rules():
    """fleet's `_warn_tp_fused_head` (reference fleet/base.py:310): an
    auto-selected fused head over a weight the tp rules vocab-shard warns
    (GPT-2's `wte`, by `spec_for`, though 50257 rows stay whole at tp 2);
    a forced one, or rules that leave it whole, do not."""
    import warnings
    from paddle_tpu_torch.distributed.fleet import base as fleet_base
    from paddle_tpu_torch.framework import program as pm, unique_name

    def build(fused_head):
        main, start = pm.Program(), pm.Program()
        with pm.program_guard(main, start), unique_name.guard():
            port_gpt.build_lm_program(port_gpt.GPTConfig(),
                                      fused_head=fused_head)
        return main

    def warned(program, rules):
        s = SimpleNamespace(tensor_parallel_rules=rules)
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            fleet_base._warn_tp_fused_head(program, s)
        return any("vocab-shard" in str(w.message) for w in seen)

    auto = build(None)
    assert warned(auto, port_gpt.tp_sharding_rules())
    assert not warned(auto, port_mesh.transformer_tp_rules())
    assert not warned(build(True), port_gpt.tp_sharding_rules())

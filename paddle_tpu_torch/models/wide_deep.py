"""The Wide&Deep CTR model (counterpart of paddle_tpu/models/wide_deep.py,
the reference's dist_fleet_ctr test model; BASELINE config 5).

26 sparse slots look up one shared table, `SparseFeatFactors`, with
row-sparse gradients (`embedding(is_sparse=True)`, ops/sparse_grad.py):
the optimizer touches the looked-up rows only. The deep side is three
fc 400 relu layers over the slots' embeddings and the 13 dense features,
the wide side one fc over the dense features. `is_distributed` marks the
table for the parameter-server pass (ROADMAP item 19.2);
`embedding_sharding_rules` shards it over the vocabulary on a dp mesh
(ROADMAP item 26 for a sparse table there)."""
from __future__ import annotations

from .. import layers
from ..layer_helper import ParamAttr
from ..parallel.mesh import P, ShardingRules


def build_ctr(sparse_slots=26, dense_dim=13, vocab_size=100001, emb_dim=10,
              is_distributed=False):
    """Returns (feeds, predict, avg_loss, auc). One int64 var per sparse
    slot, one dense float var and the click label (Criteo's layout)."""
    dense = layers.data(name="dense_input", shape=[dense_dim],
                        dtype="float32")
    sparse_ids = [layers.data(name=f"C{i}", shape=[1], dtype="int64")
                  for i in range(sparse_slots)]
    label = layers.data(name="label", shape=[1], dtype="int64")

    embs = []
    for ids in sparse_ids:
        emb = layers.embedding(
            ids, size=[vocab_size, emb_dim], is_sparse=True,
            is_distributed=is_distributed,
            param_attr=ParamAttr(name="SparseFeatFactors", initializer=None))
        embs.append(layers.reshape(emb, [-1, emb_dim]))

    # deep side
    concat = layers.concat(embs + [dense], axis=1)
    fc1 = layers.fc(concat, 400, act="relu",
                    param_attr=ParamAttr(name="deep_fc1_w"))
    fc2 = layers.fc(fc1, 400, act="relu",
                    param_attr=ParamAttr(name="deep_fc2_w"))
    fc3 = layers.fc(fc2, 400, act="relu",
                    param_attr=ParamAttr(name="deep_fc3_w"))
    # wide side
    wide = layers.fc(dense, 1, param_attr=ParamAttr(name="wide_w"))

    logit = layers.elementwise_add(layers.fc(fc3, 1), wide)
    predict = layers.sigmoid(logit)
    two_cls = layers.concat(
        [layers.elementwise_sub(
            layers.fill_constant_like(predict, 1.0), predict), predict],
        axis=1)
    loss = layers.mean(
        layers.sigmoid_cross_entropy_with_logits(
            logit, layers.cast(label, "float32")))
    auc_val, _ = layers.auc(two_cls, label)
    feeds = {"dense_input": dense, "label": label,
             **{f"C{i}": v for i, v in enumerate(sparse_ids)}}
    return feeds, predict, loss, auc_val


def embedding_sharding_rules() -> ShardingRules:
    """Shard the table over the data-parallel ranks by vocabulary rows
    (the SPMD replacement for parameter-server sparse tables)."""
    return ShardingRules([(r"^SparseFeatFactors$", P("dp", None))])

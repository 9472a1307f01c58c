"""SE-ResNeXt as a static program (counterpart of
paddle_tpu/models/se_resnext.py:14-96, the reference's distributed test
model): bottlenecks with grouped 3x3 convolutions at cardinality 32,
squeeze-excitation (a global pool, two small fcs, a sigmoid gate), a
dropout of 0.2 before a softmax head, trained on cross_entropy with
top-1 accuracy."""
from __future__ import annotations

from .. import layers
from ..layer_helper import ParamAttr
from .resnet import _static_conv_bn

_DEPTH_CFG = {
    # layers -> (block counts, stem)
    50: ([3, 4, 6, 3], "single"),
    101: ([3, 4, 23, 3], "single"),
    152: ([3, 8, 36, 3], "deep"),
}


def _conv_bn(x, ch, k, stride=1, groups=1, act="relu", name=None):
    return _static_conv_bn(x, ch, k, stride=stride, act=act, groups=groups,
                           name=name)


def _squeeze_excitation(x, ch, reduction_ratio, name):
    pool = layers.pool2d(x, pool_type="avg", global_pooling=True)
    sq = layers.fc(pool, size=ch // reduction_ratio, act="relu",
                   param_attr=ParamAttr(name=f"{name}_sq_w"),
                   bias_attr=ParamAttr(name=f"{name}_sq_b"))
    ex = layers.fc(sq, size=ch, act="sigmoid",
                   param_attr=ParamAttr(name=f"{name}_ex_w"),
                   bias_attr=ParamAttr(name=f"{name}_ex_b"))
    return layers.elementwise_mul(x, layers.unsqueeze(ex, [2, 3]))


def _shortcut(x, ch_out, stride, name):
    if x.shape[1] == ch_out and stride == 1:
        return x
    return _conv_bn(x, ch_out, 1, stride=stride, act=None, name=f"{name}_sc")


def _bottleneck(x, num_filters, stride, cardinality, reduction_ratio, name):
    y = _conv_bn(x, num_filters, 1, name=f"{name}_c1")
    y = _conv_bn(y, num_filters, 3, stride=stride, groups=cardinality,
                 name=f"{name}_c2")
    y = _conv_bn(y, num_filters * 2, 1, act=None, name=f"{name}_c3")
    y = _squeeze_excitation(y, num_filters * 2, reduction_ratio,
                            name=f"{name}_se")
    short = _shortcut(x, num_filters * 2, stride, name)
    return layers.relu(layers.elementwise_add(short, y))


def se_resnext(input, class_dim=1000, depth=50, cardinality=32,
               reduction_ratio=16, base_filters=(128, 256, 512, 1024)):
    """The SE-ResNeXt trunk and classifier head on `input` [B, 3, H, W]."""
    if depth not in _DEPTH_CFG:
        raise ValueError(f"se_resnext depth must be one of "
                         f"{sorted(_DEPTH_CFG)}, got {depth}")
    counts, stem = _DEPTH_CFG[depth]
    if stem == "deep":           # 152: three 3x3 stem convs
        x = _conv_bn(input, 64, 3, stride=2, name="stem1")
        x = _conv_bn(x, 64, 3, name="stem2")
        x = _conv_bn(x, 128, 3, name="stem3")
    else:
        x = _conv_bn(input, 64, 7, stride=2, name="stem")
    x = layers.pool2d(x, pool_size=3, pool_stride=2, pool_padding=1,
                      pool_type="max")
    for si, (n_blocks, filters) in enumerate(zip(counts, base_filters)):
        for bi in range(n_blocks):
            x = _bottleneck(
                x, filters, stride=2 if bi == 0 and si > 0 else 1,
                cardinality=cardinality, reduction_ratio=reduction_ratio,
                name=f"s{si}b{bi}")
    pool = layers.pool2d(x, pool_type="avg", global_pooling=True)
    drop = layers.dropout(pool, dropout_prob=0.2)
    return layers.fc(drop, size=class_dim, act="softmax",
                     param_attr=ParamAttr(name="head_w"),
                     bias_attr=ParamAttr(name="head_b"))


def build_se_resnext_program(class_dim=1000, depth=50,
                             image_shape=(3, 224, 224)):
    """Returns (image, label, avg_loss, accuracy)."""
    img = layers.data(name="image", shape=list(image_shape), dtype="float32")
    label = layers.data(name="label", shape=[1], dtype="int64")
    out = se_resnext(img, class_dim=class_dim, depth=depth)
    avg = layers.mean(layers.cross_entropy(input=out, label=label))
    acc = layers.accuracy(input=out, label=label)
    return img, label, avg, acc

"""ResNet-50 as a static program (counterpart of the static builder in
paddle_tpu/models/resnet.py:115-161): conv2d + batch_norm units,
bottleneck blocks at [3, 4, 6, 3], a max pool after the stem, a global
average pool and an fc head, trained on softmax cross-entropy. The
dygraph classes wait for the port's `nn` package."""
from __future__ import annotations

from .. import layers
from ..layer_helper import ParamAttr


def _static_conv_bn(x, ch, filter_size, stride=1, act=None, is_test=False,
                    groups=1, name=None):
    """conv2d (no bias, 'same' padding) then batch_norm; with `name` the
    parameters are `<name>_w`, `<name>_bn_s` / `_bn_b` and the running
    statistics `<name>_bn_mean` / `_bn_var`."""
    y = layers.conv2d(x, ch, filter_size, stride=stride,
                      padding=(filter_size - 1) // 2, bias_attr=False,
                      groups=groups,
                      param_attr=(ParamAttr(name=f"{name}_w")
                                  if name else None))
    return layers.batch_norm(
        y, act=act, is_test=is_test,
        param_attr=ParamAttr(name=f"{name}_bn_s") if name else None,
        bias_attr=ParamAttr(name=f"{name}_bn_b") if name else None,
        moving_mean_name=f"{name}_bn_mean" if name else None,
        moving_variance_name=f"{name}_bn_var" if name else None)


def _static_bottleneck(x, ch, stride, is_test=False):
    """1x1 -> 3x3 (stride) -> 1x1 x4, with a projected shortcut where the
    shape changes."""
    out = _static_conv_bn(x, ch, 1, act="relu", is_test=is_test)
    out = _static_conv_bn(out, ch, 3, stride=stride, act="relu",
                          is_test=is_test)
    out = _static_conv_bn(out, ch * 4, 1, is_test=is_test)
    if stride != 1 or x.shape[1] != ch * 4:
        x = _static_conv_bn(x, ch * 4, 1, stride=stride, is_test=is_test)
    return layers.relu(layers.elementwise_add(out, x))


def build_resnet50_program(num_classes=1000, image_size=224, is_test=False):
    """Static ResNet-50: returns (image_var, label_var, avg_loss)."""
    img = layers.data(name="image", shape=[3, image_size, image_size],
                      dtype="float32")
    label = layers.data(name="label", shape=[1], dtype="int64")
    x = _static_conv_bn(img, 64, 7, stride=2, act="relu", is_test=is_test)
    x = layers.pool2d(x, pool_size=3, pool_type="max", pool_stride=2,
                      pool_padding=1)
    for ch, depth, first_stride in ((64, 3, 1), (128, 4, 2),
                                    (256, 6, 2), (512, 3, 2)):
        for i in range(depth):
            x = _static_bottleneck(x, ch, first_stride if i == 0 else 1,
                                   is_test=is_test)
    x = layers.pool2d(x, pool_type="avg", global_pooling=True)
    logits = layers.fc(layers.flatten(x, axis=1), num_classes)
    loss = layers.mean(layers.softmax_with_cross_entropy(logits, label))
    return img, label, loss

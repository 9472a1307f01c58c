"""LeNet-5 as a static program (counterpart of
paddle_tpu/models/lenet.py:11-23, the model of the reference's
recognize_digits book test). The dygraph class waits for the port's `nn`
package."""
from __future__ import annotations

from .. import layers


def build_static(img, label):
    """Returns (logits, avg_loss, accuracy)."""
    c1 = layers.conv2d(img, num_filters=6, filter_size=5, padding=2,
                       act="relu")
    p1 = layers.pool2d(c1, pool_size=2, pool_stride=2)
    c2 = layers.conv2d(p1, num_filters=16, filter_size=5, act="relu")
    p2 = layers.pool2d(c2, pool_size=2, pool_stride=2)
    f1 = layers.fc(p2, size=120, act="relu")
    f2 = layers.fc(f1, size=84, act="relu")
    logits = layers.fc(f2, size=10)
    loss = layers.mean(layers.softmax_with_cross_entropy(logits, label))
    acc = layers.accuracy(layers.softmax(logits), label)
    return logits, loss, acc

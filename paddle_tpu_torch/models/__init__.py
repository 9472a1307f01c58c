"""Model zoo of the port: GPT decode (serving), BERT and GPT-2 training,
the static image models (ResNet-50, SE-ResNeXt, LeNet) and the Wide&Deep
CTR model."""
from .wide_deep import build_ctr, embedding_sharding_rules

__all__ = ["build_ctr", "embedding_sharding_rules"]

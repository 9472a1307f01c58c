"""Model zoo of the port: GPT decode (serving), BERT and GPT-2 training,
and the static image models (ResNet-50, SE-ResNeXt, LeNet)."""

"""GPT-style causal-decoder LM geometry (the counterpart of
paddle_tpu/models/gpt.py's GPTConfig; the static-graph program builder is
not ported). Pre-LN blocks, batch-major [B, S, H], tied input/output
embeddings. The default is GPT-2 small."""
from __future__ import annotations

from dataclasses import dataclass


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

    @staticmethod
    def small():
        return GPTConfig()

    @staticmethod
    def tiny():
        return GPTConfig(vocab_size=512, hidden_size=64, num_layers=2,
                         num_heads=4, intermediate_size=128,
                         max_position=64, seq_len=32,
                         hidden_dropout=0.0, attention_dropout=0.0)

"""Architecture registry: --arch <id> resolution for launchers and tests.

The port carries every architecture of JAX's registry: qwen3-0.6b and
rwkv6-1.6b (serving and decoder-LM fine-tuning), starcoder2-3b and
starcoder2-7b (serving a pre-LN LayerNorm decoder with biases and an
untied head), gemma2-27b (serving over windowed ring caches),
recurrentgemma-2b (serving RG-LRU blocks beside windowed MQA),
deepseek-moe-16b and qwen3-moe-235b-a22b (mixture-of-experts serving; the
latter, 470 GB in bf16, at its smoke dims), whisper-tiny (the
encoder-decoder family) and internvl2-76b (the VLM family), and the
paper's own BERT-family encoders (two-stage training, MLM pretraining).
"""
from __future__ import annotations

from repro_torch.common.types import ModelCfg
from repro_torch.configs import (bert, deepseek_moe_16b, gemma2_27b,
                                 internvl2_76b, qwen3_0_6b,
                                 qwen3_moe_235b_a22b, recurrentgemma_2b,
                                 rwkv6_1_6b, starcoder2_3b, starcoder2_7b,
                                 whisper_tiny)

ASSIGNED = {
    "deepseek-moe-16b": deepseek_moe_16b,
    "qwen3-moe-235b-a22b": qwen3_moe_235b_a22b,
    "gemma2-27b": gemma2_27b,
    "internvl2-76b": internvl2_76b,
    "qwen3-0.6b": qwen3_0_6b,
    "recurrentgemma-2b": recurrentgemma_2b,
    "rwkv6-1.6b": rwkv6_1_6b,
    "starcoder2-3b": starcoder2_3b,
    "starcoder2-7b": starcoder2_7b,
    "whisper-tiny": whisper_tiny,
}

# the paper's own PLMs (encoder classifiers for the GLUE-style benchmarks)
PAPER = {
    "bert-base": bert.bert_base,
    "bert-large": bert.bert_large,
    "roberta-base": bert.roberta_base,
    "roberta-large": bert.roberta_large,
    "bert-small": bert.bert_small,
    "bert-tiny": bert.bert_tiny,
}


def list_archs():
    return sorted(ASSIGNED)


def get(name: str) -> ModelCfg:
    if name in ASSIGNED:
        return ASSIGNED[name].config()
    if name in PAPER:
        return PAPER[name]()
    raise KeyError(f"unknown arch {name!r}; known: "
                   f"{list_archs() + sorted(PAPER)}")


def get_smoke(name: str) -> ModelCfg:
    if name in ASSIGNED:
        return ASSIGNED[name].smoke()
    if name in PAPER:
        return bert.smoke()
    raise KeyError(f"unknown arch {name!r}; known: "
                   f"{list_archs() + sorted(PAPER)}")

"""recurrentgemma-2b [arXiv:2402.19427]: 26L d=2560 10H (MQA kv=1,
head_dim=256) d_ff=7680 vocab=256000; RG-LRU + local attention, pattern
(rec, rec, attn-window-2048) -> attn:rec = 1:2. 2.894 B parameters, 5.79
GB in bf16: the rec layers' 1,651 M, the attention layers' 587 M and the
tied embedding's 655 M."""
from repro_torch.common.types import Group, ModelCfg, Slot
from repro_torch.configs.util import smoke_dims

WINDOW = 2048


def config() -> ModelCfg:
    return ModelCfg(
        name="recurrentgemma-2b",
        family="decoder",
        d_model=2560,
        n_heads=10,
        n_kv_heads=1,
        head_dim=256,
        d_ff=7680,
        vocab_size=256000,
        groups=(
            Group((Slot("rec"), Slot("rec"), Slot("attn", window=WINDOW)), 8),
            Group((Slot("rec"), Slot("rec")), 1),
        ),
        lru_width=2560,
        conv1d_width=4,
        norm="rmsnorm",
        act="gelu",
        gated_mlp=True,
        pos="rope",
        rope_theta=10000.0,
        embed_scale=True,
        tie_embeddings=True,
        max_seq_len=524288,
        shard_profile="tp",
    )


def smoke() -> ModelCfg:
    cfg = config()
    return smoke_dims(
        cfg,
        n_kv_heads=1,
        groups=(
            Group((Slot("rec"), Slot("rec"), Slot("attn", window=16)), 1),
            Group((Slot("rec"), Slot("rec")), 1),
        ),
    )

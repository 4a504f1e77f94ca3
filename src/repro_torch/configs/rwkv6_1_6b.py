"""rwkv6-1.6b "Finch" [arXiv:2404.05892]: 24L d=2048, attention-free
(data-dependent decay WKV), channel-mix d_ff=7168, vocab=65536."""
from repro_torch.common.types import Group, ModelCfg, Slot
from repro_torch.configs.util import smoke_dims


def config() -> ModelCfg:
    return ModelCfg(
        name="rwkv6-1.6b",
        family="decoder",
        d_model=2048,
        n_heads=32,  # d_model / rwkv_head_dim (informational)
        n_kv_heads=32,
        head_dim=64,
        rwkv_head_dim=64,
        d_ff=7168,
        vocab_size=65536,
        groups=(Group((Slot("rwkv"),), 24),),
        norm="layernorm",
        pos="none",
        gated_mlp=False,
        act="relu2",
        max_seq_len=524288,
        shard_profile="tp",
    )


def smoke() -> ModelCfg:
    cfg = config()
    return smoke_dims(cfg, groups=(Group((Slot("rwkv"),), 2),))

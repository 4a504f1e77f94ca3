"""deepseek-moe-16b [arXiv:2401.06066]: 28L d=2048 16H (MHA) vocab=102400,
fine-grained MoE: 64 routed experts (d_expert=1408) top-6 + 2 shared,
first layer dense (d_ff=10944). 16.4 B parameters, 32.8 GB in bf16: one
80 GB card holds it whole."""
from repro_torch.common.types import Group, ModelCfg, MoECfg, Slot
from repro_torch.configs.util import smoke_dims


def config() -> ModelCfg:
    return ModelCfg(
        name="deepseek-moe-16b",
        family="decoder",
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        head_dim=128,
        d_ff=10944,  # dense first layer / reference width
        vocab_size=102400,
        groups=(
            Group((Slot("attn", moe=False),), 1),
            Group((Slot("attn", moe=True),), 27),
        ),
        moe=MoECfg(n_experts=64, top_k=6, d_expert=1408, n_shared=2,
                   normalize_weights=False),
        norm="rmsnorm",
        act="silu",
        gated_mlp=True,
        pos="rope",
        rope_theta=10000.0,
        max_seq_len=32768,
        shard_profile="tp",
    )


def smoke() -> ModelCfg:
    cfg = config()
    return smoke_dims(
        cfg,
        groups=(
            Group((Slot("attn", moe=False),), 1),
            Group((Slot("attn", moe=True),), 2),
        ),
        moe=MoECfg(n_experts=8, top_k=2, d_expert=32, n_shared=1,
                   normalize_weights=False),
    )

"""qwen3-moe-235b-a22b [hf:Qwen/Qwen3-30B-A3B family scaled]: 94L d=4096
64H (GQA kv=4, head_dim=128, qk-norm), 128 experts (d_expert=1536) top-8.
About 470 GB in bf16: no one card holds it, so the port runs it at its
smoke dims on the CPU and its attention shapes on the card."""
from repro_torch.common.types import Group, ModelCfg, MoECfg, Slot
from repro_torch.configs.util import smoke_dims


def config() -> ModelCfg:
    return ModelCfg(
        name="qwen3-moe-235b-a22b",
        family="decoder",
        d_model=4096,
        n_heads=64,
        n_kv_heads=4,
        head_dim=128,
        d_ff=1536,
        vocab_size=151936,
        groups=(Group((Slot("attn", moe=True),), 94),),
        moe=MoECfg(n_experts=128, top_k=8, d_expert=1536, n_shared=0,
                   normalize_weights=True),
        norm="rmsnorm",
        act="silu",
        gated_mlp=True,
        qk_norm=True,
        pos="rope",
        rope_theta=1e6,
        max_seq_len=32768,
        shard_profile="tp_fsdp",
    )


def smoke() -> ModelCfg:
    cfg = config()
    return smoke_dims(
        cfg,
        groups=(Group((Slot("attn", moe=True),), 2),),
        moe=MoECfg(n_experts=8, top_k=2, d_expert=32, n_shared=0),
    )

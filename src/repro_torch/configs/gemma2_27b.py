"""gemma2-27b [arXiv:2408.00118]: 46L d=4608 32H (GQA kv=16, head_dim=128)
d_ff=36864 vocab=256000; alternating local(4096)/global attention, attn
softcap 50, final logit softcap 30, post-norms, query scale (d/H)^-0.5.
27.2 B parameters, 54.5 GB in bf16: the largest of the port's configs,
which one 80 GB card holds whole."""
from repro_torch.common.types import Group, ModelCfg, Slot
from repro_torch.configs.util import smoke_dims

LOCAL_WINDOW = 4096


def config() -> ModelCfg:
    return ModelCfg(
        name="gemma2-27b",
        family="decoder",
        d_model=4608,
        n_heads=32,
        n_kv_heads=16,
        head_dim=128,
        d_ff=36864,
        vocab_size=256000,
        groups=(Group((Slot("attn", window=LOCAL_WINDOW), Slot("attn")), 23),),
        norm="rmsnorm",
        act="gelu",
        gated_mlp=True,
        post_norms=True,
        attn_softcap=50.0,
        final_softcap=30.0,
        query_scale=(4608 / 32) ** -0.5,
        pos="rope",
        rope_theta=10000.0,
        embed_scale=True,
        tie_embeddings=True,
        max_seq_len=32768,
        shard_profile="tp_fsdp",
    )


def smoke() -> ModelCfg:
    cfg = config()
    return smoke_dims(
        cfg,
        groups=(Group((Slot("attn", window=16), Slot("attn")), 1),),
        query_scale=None,
        attn_softcap=50.0,
    )

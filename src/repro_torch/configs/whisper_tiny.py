"""whisper-tiny [arXiv:2212.04356]: enc-dec, 4L+4L d=384 6H d_ff=1536
vocab=51865; the conv frontend is stubbed: `encode_audio` takes
precomputed (B, 1500, 384) frame embeddings. The decoder's position table
is scaled to 32k decode positions (the backbone, not OpenAI's 448-token
table). 49,646,976 parameters with Hadamard adapters on both stacks."""
from repro_torch.common.types import Group, ModelCfg, Slot
from repro_torch.configs.util import smoke_dims


def config() -> ModelCfg:
    return ModelCfg(
        name="whisper-tiny",
        family="encdec",
        d_model=384,
        n_heads=6,
        n_kv_heads=6,
        head_dim=64,
        d_ff=1536,
        vocab_size=51865,
        groups=(Group((Slot("attn", cross_attn=True),), 4),),
        enc_groups=(Group((Slot("attn"),), 4),),
        n_audio_frames=1500,
        norm="layernorm",
        ln_placement="pre",
        act="gelu",
        gated_mlp=False,
        attn_bias=True,
        mlp_bias=True,
        pos="learned",
        tie_embeddings=True,
        max_seq_len=32768,
        shard_profile="tp",
    )


def smoke() -> ModelCfg:
    cfg = config()
    return smoke_dims(
        cfg,
        n_kv_heads=4,
        groups=(Group((Slot("attn", cross_attn=True),), 2),),
        enc_groups=(Group((Slot("attn"),), 2),),
    )

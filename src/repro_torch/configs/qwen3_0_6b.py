"""qwen3-0.6b [hf:Qwen/Qwen3-8B family]: 28L d=1024 16H (GQA kv=8,
head_dim=128) d_ff=3072 vocab=151936, qk-norm, tied embeddings."""
from repro_torch.common.types import ModelCfg
from repro_torch.configs.util import dense_decoder, smoke_dims


def config() -> ModelCfg:
    return ModelCfg(
        name="qwen3-0.6b",
        family="decoder",
        d_model=1024,
        n_heads=16,
        n_kv_heads=8,
        head_dim=128,
        d_ff=3072,
        vocab_size=151936,
        groups=dense_decoder(28),
        norm="rmsnorm",
        act="silu",
        gated_mlp=True,
        qk_norm=True,
        pos="rope",
        rope_theta=1e6,
        tie_embeddings=True,
        max_seq_len=32768,
        shard_profile="tp",
    )


def smoke() -> ModelCfg:
    return smoke_dims(config(), groups=dense_decoder(2))

"""starcoder2-7b [arXiv:2402.19173]: 32L d=4608 36H (GQA kv=4, head_dim=128)
d_ff=18432 vocab=49152; pre-LN LayerNorm with biases, non-gated GeLU,
RoPE, an untied head. 7,400,711,168 parameters with Hadamard adapters,
~14.80 GB in bf16."""
from repro_torch.common.types import ModelCfg
from repro_torch.configs.util import dense_decoder, smoke_dims


def config() -> ModelCfg:
    return ModelCfg(
        name="starcoder2-7b",
        family="decoder",
        d_model=4608,
        n_heads=36,
        n_kv_heads=4,
        head_dim=128,
        d_ff=18432,
        vocab_size=49152,
        groups=dense_decoder(32),
        norm="layernorm",
        act="gelu",
        gated_mlp=False,
        attn_bias=True,
        mlp_bias=True,
        pos="rope",
        rope_theta=1e5,
        max_seq_len=32768,
        shard_profile="tp",
    )


def smoke() -> ModelCfg:
    return smoke_dims(config(), groups=dense_decoder(2))

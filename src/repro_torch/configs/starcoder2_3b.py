"""starcoder2-3b [arXiv:2402.19173]: 30L d=3072 24H (GQA kv=2, head_dim=128)
d_ff=12288 vocab=49152; pre-LN LayerNorm with biases, non-gated GeLU,
RoPE, an untied head. 3,181,550,592 parameters with Hadamard adapters,
~6.36 GB in bf16."""
from repro_torch.common.types import ModelCfg
from repro_torch.configs.util import dense_decoder, smoke_dims


def config() -> ModelCfg:
    return ModelCfg(
        name="starcoder2-3b",
        family="decoder",
        d_model=3072,
        n_heads=24,
        n_kv_heads=2,
        head_dim=128,
        d_ff=12288,
        vocab_size=49152,
        groups=dense_decoder(30),
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

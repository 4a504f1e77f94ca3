"""internvl2-76b [arXiv:2404.16821]: InternLM2/Llama3-70B-class backbone,
80L d=8192 64H (GQA kv=8, head_dim=128) d_ff=28672 vocab=128256.
The InternViT frontend is stubbed: `forward_lm`/`prefill_lm` take
precomputed (B, 256, 8192) patch embeddings, projected by `vlm_proj` and
prepended to the token sequence. 70,622,126,080 parameters with Hadamard
adapters (855,670,784 a layer), ~141 GB in bf16: one card holds it only at
a cut depth."""
from repro_torch.common.types import ModelCfg
from repro_torch.configs.util import dense_decoder, smoke_dims


def config() -> ModelCfg:
    return ModelCfg(
        name="internvl2-76b",
        family="vlm",
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        head_dim=128,
        d_ff=28672,
        vocab_size=128256,
        groups=dense_decoder(80),
        n_image_tokens=256,
        norm="rmsnorm",
        act="silu",
        gated_mlp=True,
        pos="rope",
        rope_theta=5e5,
        max_seq_len=32768,
        shard_profile="tp_fsdp",
    )


def smoke() -> ModelCfg:
    return smoke_dims(config(), groups=dense_decoder(2))

"""Helpers shared by architecture configs (port of `repro.configs.util`)."""
from __future__ import annotations

from repro_torch.common.types import Group, ModelCfg, Slot


def dense_decoder(n_layers: int, window=None) -> tuple:
    return (Group((Slot("attn", window=window),), n_layers),)


def smoke_dims(cfg: ModelCfg, **overrides) -> ModelCfg:
    """Shrink a config for CPU smoke tests, preserving family + pattern."""
    kw = dict(
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=503,
        max_seq_len=128,
        param_dtype="float32",
        compute_dtype="float32",
        sequence_sharding=False,
        q_chunk=16,
        kv_chunk=16,
        n_image_tokens=4 if cfg.n_image_tokens else 0,
        n_audio_frames=8,
        lru_width=64 if cfg.lru_width else None,
        rwkv_head_dim=16,
        shard_profile="tp",
    )
    kw.update(overrides)
    return cfg.replace(name=cfg.name + "-smoke", **kw)

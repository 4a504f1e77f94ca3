"""Configuration dataclasses (port of `repro.common.types`).

Field names and defaults follow the JAX package so a config built on one
side reads the same on the other. Dtypes stay strings ("bfloat16",
"float32"); `ModelCfg.pdtype`/`cdtype` map them to `torch.dtype`.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
}


def torch_dtype(name: str) -> torch.dtype:
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"unsupported dtype {name!r}; known: {sorted(_DTYPES)}")


@dataclass(frozen=True)
class AdapterCfg:
    """The injected adapter. kind 'hadamard' is the paper's per-layer
    (w, b) vectors applied elementwise to the attention-block output;
    'none' has no adapter params. position 'attn_out' (default) or
    'attn_concat' (Eq. 7 literal placement, before W_O)."""

    kind: str = "none"
    position: str = "attn_out"
    lora_rank: int = 8
    lora_alpha: float = 16.0
    houlsby_dim: int = 64
    top_layers: Optional[int] = None

    @property
    def enabled(self) -> bool:
        return self.kind != "none"


@dataclass(frozen=True)
class MoECfg:
    """A mixture-of-experts FFN (`models/moe.py`): n_experts routed
    experts of width d_expert, top_k of them a token, capacity_factor
    times the even share of routes each (the rest dropped), n_shared
    always-on experts; gates renormalized over the top k when
    normalize_weights is set; the router computed in router_dtype; the
    load-balancing loss weighted by aux_loss_weight."""

    n_experts: int
    top_k: int
    d_expert: int
    n_shared: int = 0
    capacity_factor: float = 1.25
    normalize_weights: bool = True
    router_dtype: str = "float32"
    aux_loss_weight: float = 0.01


@dataclass(frozen=True)
class Slot:
    """One block position inside a repeating pattern.

    kind: 'attn' | 'rec' (RG-LRU) | 'rwkv' (RWKV6 time-mix)
    window: local attention window (None = full attention)
    moe: the block's FFN is a mixture of experts (cfg.moe)
    """

    kind: str = "attn"
    window: Optional[int] = None
    moe: bool = False
    cross_attn: bool = False


@dataclass(frozen=True)
class Group:
    """`repeats` copies of the slot pattern."""

    slots: Tuple[Slot, ...]
    repeats: int

    @property
    def n_layers(self) -> int:
        return len(self.slots) * self.repeats


@dataclass(frozen=True)
class ModelCfg:
    name: str
    family: str  # 'decoder' | 'encoder' | 'encdec' | 'vlm'
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    groups: Tuple[Group, ...]
    enc_groups: Tuple[Group, ...] = ()

    moe: Optional[MoECfg] = None
    adapter: AdapterCfg = AdapterCfg()

    norm: str = "rmsnorm"  # 'rmsnorm' | 'layernorm'
    norm_eps: float = 1e-6
    ln_placement: str = "pre"  # 'pre' | 'post' (BERT-style)
    post_norms: bool = False

    act: str = "silu"
    gated_mlp: bool = True
    attn_bias: bool = False
    mlp_bias: bool = False

    pos: str = "rope"  # 'rope' | 'learned' | 'none'
    rope_theta: float = 10000.0
    max_seq_len: int = 8192
    qk_norm: bool = False
    attn_softcap: float = 0.0
    final_softcap: float = 0.0
    query_scale: Optional[float] = None  # default 1/sqrt(head_dim)

    tie_embeddings: bool = False
    embed_scale: bool = False

    n_segment_types: int = 0
    pooler: bool = False
    n_classes: int = 2
    is_regression: bool = False

    lru_width: Optional[int] = None
    conv1d_width: int = 4

    rwkv_head_dim: int = 64
    rwkv_chunk: int = 128

    n_image_tokens: int = 0
    n_audio_frames: int = 1500

    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"

    # kept for field parity with the JAX config; the port does not read them
    shard_profile: str = "tp"
    sequence_sharding: bool = True
    remat: bool = True
    remat_policy: str = "none"
    q_chunk: int = 512
    kv_chunk: int = 1024
    replicate_kv: bool = False
    ce_chunk: int = 0
    attn_tile_dtype: str = "float32"

    def replace(self, **kw) -> "ModelCfg":
        return dataclasses.replace(self, **kw)

    @property
    def n_layers(self) -> int:
        return sum(g.n_layers for g in self.groups) + sum(
            g.n_layers for g in self.enc_groups
        )

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def pdtype(self) -> torch.dtype:
        return torch_dtype(self.param_dtype)

    @property
    def cdtype(self) -> torch.dtype:
        return torch_dtype(self.compute_dtype)

    def layer_slots(self) -> Tuple[Slot, ...]:
        """The decoder stack's slots in execution order, one per layer.
        `n_layers` counts both stacks, as JAX's does; a per-layer array of
        the decoder (gate rows, depth masks, caches) is sized by this."""
        return tuple(s for g in self.groups for _ in range(g.repeats)
                     for s in g.slots)

    def enc_layer_slots(self) -> Tuple[Slot, ...]:
        """The encoder stack's slots (an encdec config's `enc_groups`) in
        execution order, one per layer; empty for every other family."""
        return tuple(s for g in self.enc_groups for _ in range(g.repeats)
                     for s in g.slots)


# ---------------------------------------------------------------------------
# Optimizer / training configuration
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class OptimCfg:
    lr: float = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.01
    grad_clip: float = 1.0
    schedule: str = "cosine"  # 'constant' | 'linear' | 'cosine'
    warmup_steps: int = 0
    total_steps: int = 1000
    min_lr_ratio: float = 0.1
    # int8 gradient compression with error feedback (optim/compression)
    # and the AdamW moments' storage: 'float32' | 'bfloat16' | 'int8',
    # int8 with error-feedback residuals unless qstate_ef is off
    # (optim/qstate)
    compress_grads: bool = False
    m_dtype: str = "float32"
    v_dtype: str = "float32"
    qstate_ef: bool = True


@dataclass(frozen=True)
class TrainCfg:
    optim: OptimCfg = OptimCfg()
    batch_size: int = 16
    seq_len: int = 128
    steps: int = 100
    eval_every: int = 50
    microbatch: int = 0  # 0 = no gradient accumulation
    seed: int = 0
    log_every: int = 10

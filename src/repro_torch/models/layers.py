"""Shared building blocks (port of `repro.models.layers`): init, norms,
RoPE and the MLP, as plain functions on tensors and parameter dicts."""
from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.common.types import ModelCfg
from repro_torch.dist.api import (copy_to_model, reduce_from_model,
                                  split_to_model)
from repro_torch.quant.qtensor import qdense

# ---------------------------------------------------------------------------
# Initializers
# ---------------------------------------------------------------------------


def gen_device(gen: Optional[torch.Generator]) -> torch.device:
    """Where init puts its tensors: the generator's device; with no
    generator, the default device (shapes only, e.g. under
    `with torch.device("meta")`, as `jax.eval_shape` gives them)."""
    return gen.device if gen is not None else torch.get_default_device()


def dense_init(gen: Optional[torch.Generator], d_in: int, d_out: int, dtype,
               scale: Optional[float] = None) -> torch.Tensor:
    """Truncated normal (+-2 std) times `scale` (0.02), drawn in fp32 on
    the generator's device, stored in `dtype`; uninitialised without a
    generator."""
    scale = 0.02 if scale is None else scale
    t = torch.empty((d_in, d_out), dtype=torch.float32, device=gen_device(gen))
    if gen is None:
        return t.to(dtype)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (t * scale).to(dtype)


def embed_init(gen: torch.Generator, n: int, d: int, dtype,
               scale: float = 0.02) -> torch.Tensor:
    return dense_init(gen, n, d, dtype, scale)


@contextlib.contextmanager
def full_fp32():
    """fp32 matmuls at full precision (no TF32) inside the block: the MoE
    router's logits and the RG-LRU's gates, which JAX computes in fp32."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


# ---------------------------------------------------------------------------
# Normalisation
# ---------------------------------------------------------------------------


def norm_init(cfg: ModelCfg, device, d: Optional[int] = None) -> dict:
    d = d or cfg.d_model
    p = {"scale": torch.ones((d,), dtype=cfg.pdtype, device=device)}
    if cfg.norm == "layernorm":
        p["bias"] = torch.zeros((d,), dtype=cfg.pdtype, device=device)
    return p


def apply_norm(p: dict, cfg: ModelCfg, x: torch.Tensor) -> torch.Tensor:
    """RMSNorm or LayerNorm, computed in fp32."""
    x32 = x.float()
    if cfg.norm == "layernorm":
        mu = x32.mean(-1, keepdim=True)
        var = (x32 - mu).square().mean(-1, keepdim=True)
        y = (x32 - mu) * torch.rsqrt(var + cfg.norm_eps)
        y = y * p["scale"].float() + p["bias"].float()
    else:
        ms = x32.square().mean(-1, keepdim=True)
        y = x32 * torch.rsqrt(ms + cfg.norm_eps) * p["scale"].float()
    return y.to(x.dtype)


def rms_head_norm(scale: torch.Tensor, x: torch.Tensor,
                  eps: float = 1e-6) -> torch.Tensor:
    """Per-head RMSNorm over the trailing head_dim (qwen3 qk-norm)."""
    x32 = x.float()
    ms = x32.square().mean(-1, keepdim=True)
    return (x32 * torch.rsqrt(ms + eps) * scale.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# Activations / MLP
# ---------------------------------------------------------------------------


def act_fn(name: str):
    return {
        "silu": F.silu,
        "gelu": lambda x: F.gelu(x, approximate="tanh"),
        "relu": F.relu,
        "relu2": lambda x: F.relu(x).square(),
    }[name]


def mlp_init(gen: torch.Generator, cfg: ModelCfg) -> dict:
    p = {
        "wi": dense_init(gen, cfg.d_model, cfg.d_ff, cfg.pdtype),
        "wo": dense_init(gen, cfg.d_ff, cfg.d_model, cfg.pdtype),
    }
    if cfg.gated_mlp:
        p["wg"] = dense_init(gen, cfg.d_model, cfg.d_ff, cfg.pdtype)
    if cfg.mlp_bias:
        dev = gen_device(gen)
        p["bi"] = torch.zeros((cfg.d_ff,), dtype=cfg.pdtype, device=dev)
        p["bo"] = torch.zeros((cfg.d_model,), dtype=cfg.pdtype, device=dev)
    return p


def apply_mlp(p: dict, cfg: ModelCfg, x: torch.Tensor,
              impl: str = "auto",
              ia3: Optional[torch.Tensor] = None) -> torch.Tensor:
    """ia3: the IA3 baseline's (d_ff,) scale of the activation, after the
    gate and before wo."""
    cdt = cfg.cdtype
    x = copy_to_model(x)  # Megatron's MLP under a mesh: wi/wg columns,
    h = qdense(x, p["wi"], cdt, impl, tag="mlp/wi")
    if "bi" in p:
        h = h + p["bi"].to(cdt)
    h = act_fn(cfg.act)(h)
    if cfg.gated_mlp:
        h = h * qdense(x, p["wg"], cdt, impl, tag="mlp/wg")
    if ia3 is not None:
        h = h * split_to_model(ia3).to(cdt)
    # wo rows: the partial sums meet before the bias, added once
    y = reduce_from_model(qdense(h, p["wo"], cdt, impl, tag="mlp/wo"))
    if "bo" in p:
        y = y + p["bo"].to(cdt)
    return y


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    return 1.0 / (theta ** exponent)  # (head_dim/2,)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions broadcastable to
    (..., seq). Rotates the two halves of head_dim, computed in fp32."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    angles = positions.float()[..., None] * freqs  # (..., seq, hd/2)
    cos = angles.cos()[..., None, :]
    sin = angles.sin()[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    y = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return y.to(x.dtype)

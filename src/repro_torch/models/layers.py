"""Shared building blocks (port of `repro.models.layers`): init, norms,
RoPE and the MLP, as plain functions on tensors and parameter dicts."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.common.types import ModelCfg

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


def dense(x: torch.Tensor, w: torch.Tensor, dtype) -> torch.Tensor:
    """x @ w in the compute dtype (a plain matmul, left to the library as
    the JAX package leaves it to XLA)."""
    return torch.matmul(x.to(dtype), w.to(dtype))


def apply_mlp(p: dict, cfg: ModelCfg, x: torch.Tensor) -> torch.Tensor:
    cdt = cfg.cdtype
    h = dense(x, p["wi"], cdt)
    if "bi" in p:
        h = h + p["bi"].to(cdt)
    h = act_fn(cfg.act)(h)
    if cfg.gated_mlp:
        h = h * dense(x, p["wg"], cdt)
    y = dense(h, p["wo"], cdt)
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

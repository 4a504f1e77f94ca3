"""Quantized AdamW moment storage (port of `repro.optim.qstate`): bf16 or
row-wise int8 optimizer state.

Each moment is stored in the representation `OptimCfg.m_dtype` /
`v_dtype` names:

  'float32'  - exact; encode and decode are the identity, so the update is
               bit for bit the fp32 AdamW.
  'bfloat16' - a plain cast: half the bytes.
  'int8'     - a `QTensor` with one fp32 scale per trailing-dim row,
               quantized as JAX's jitted step does (`quantize_jitted`).

With int8 and error feedback (`OptimCfg.qstate_ef`), the moment is
reconstructed as decode(stored) + decode(err) before the EMA update, and
the fresh quantization error is re-encoded, row-wise int8 too, into an
`m_err`/`v_err` residual: a small EMA increment then cannot stall on the
int8 grid.

Trees here are the port's flat dicts {path: tensor}. The port keeps one
tensor per layer where JAX stacks a group's layers on a leading dim; the
scales are per row of the trailing dim, so a layer's moment is byte for
byte the slice of JAX's stacked one, and the byte counts
(`moment_bytes`, `state_summary`) are JAX's: the same values and the same
number of fp32 scales, and the step count an int32 scalar.

Bytes per parameter (scales amortized over the trailing dim): fp32 8.0;
bf16 4.0 (2.0x); m bf16 + v int8 with EF ~4.1, without ~3.0; all int8
without EF ~2.1 (~3.9x, a memory floor: no-EF int8 v deadzones and the
step diverges).
"""
from __future__ import annotations

from typing import Dict, Iterable, Optional

import torch

from repro_torch.quant.qtensor import is_qtensor, quantize_jitted, residual_of

MOMENT_DTYPES = ("float32", "bfloat16", "int8")
_COUNT_BYTES = 4  # JAX's step count: an int32 scalar


def check_moment_dtype(name: str, dtype: str) -> str:
    if dtype not in MOMENT_DTYPES:
        raise ValueError(
            f"{name} must be one of {MOMENT_DTYPES} (got {dtype!r})")
    return dtype


def quantized_moments(ocfg) -> bool:
    """True when either moment leaves its exact fp32 representation."""
    return (ocfg.m_dtype, ocfg.v_dtype) != ("float32", "float32")


def decode_moment(stored) -> Optional[torch.Tensor]:
    """Stored representation -> fp32 tensor (identity for fp32)."""
    if stored is None:
        return None
    if is_qtensor(stored):
        return stored.dequantize(torch.float32)
    return stored.to(torch.float32)


def encode_moment(x32: torch.Tensor, dtype: str, *, ef: bool = False):
    """fp32 moment -> (stored, residual). The residual is None unless dtype
    is 'int8' and `ef`: then it is the row-wise int8 QTensor of the
    quantization error, added back at the next decode."""
    if dtype == "float32":
        return x32, None
    if dtype == "bfloat16":
        return x32.to(torch.bfloat16), None
    if dtype == "int8":
        q = quantize_jitted(x32, "int8", axis=-1)
        if not ef:
            return q, None
        return q, quantize_jitted(residual_of(x32, q), "int8", axis=-1)
    raise ValueError(f"unknown moment dtype {dtype!r}")


def init_moment(leaf: torch.Tensor, dtype: str):
    """The zero moment of one trainable leaf, stored as `dtype`."""
    z = torch.zeros(leaf.shape, dtype=torch.float32, device=leaf.device)
    return encode_moment(z, dtype)[0]


def init_opt_state(trainable: Dict[str, torch.Tensor], ocfg,
                   decay: Iterable[str] = ()) -> dict:
    """AdamW state over `trainable`: {m, v, count, decay} with the moments
    in `ocfg`'s dtypes; int8 moments with error feedback add an
    `m_err`/`v_err` residual dict. `decay` names the leaves that take
    weight decay (JAX decays by rank, see `optim.adamw`)."""
    m_dt = check_moment_dtype("m_dtype", ocfg.m_dtype)
    v_dt = check_moment_dtype("v_dtype", ocfg.v_dtype)
    ef = bool(ocfg.qstate_ef)

    def moments(dtype):
        return {k: init_moment(p, dtype) for k, p in trainable.items()}

    state = {"m": moments(m_dt), "v": moments(v_dt), "count": 0,
             "decay": frozenset(decay)}
    if m_dt == "int8" and ef:
        state["m_err"] = moments("int8")
    if v_dt == "int8" and ef:
        state["v_err"] = moments("int8")
    return state


def _bytes(leaf) -> int:
    return leaf.nbytes if is_qtensor(leaf) else leaf.numel() * \
        leaf.element_size()


def moment_bytes(opt_state: dict) -> int:
    """Device bytes of the optimizer state as JAX counts them: moment
    payloads, scales, error-feedback residuals and the int32 count."""
    return _COUNT_BYTES + sum(
        _bytes(leaf) for key in ("m", "v", "m_err", "v_err")
        for leaf in opt_state.get(key, {}).values())


def state_summary(opt_state: dict, ocfg=None) -> dict:
    """Byte accounting for the launchers' prints, JAX's dict."""
    n_params = sum(leaf.numel() for leaf in opt_state["m"].values())
    got = moment_bytes(opt_state)
    fp32 = 2 * 4 * n_params + _COUNT_BYTES  # m + v fp32, plus the count
    return {
        "n_params": n_params,
        "bytes": got,
        "bytes_fp32": fp32,
        "ratio": fp32 / got if got else 1.0,
        "m_dtype": getattr(ocfg, "m_dtype", None),
        "v_dtype": getattr(ocfg, "v_dtype", None),
    }


"""PEFT strategies (port of `repro.core.peft`, the serving subset).

A strategy names the adapter kind a config carries and the parameter
paths it trains. The serving slice needs `attach` and the paper's
"hadamard" strategy; masks, stages and layer gating arrive with training.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

from repro_torch.common.types import AdapterCfg, ModelCfg

# paper Table 4 module names: W = adapter weight, B = adapter bias,
# N = ffn-output ("post-intermediate") norm
MODULE_PATTERNS = {
    "W": (r"/adapter/w$",),
    "B": (r"/adapter/b$",),
    "N": (r"/ffn_norm/",),
}


@dataclass(frozen=True)
class Strategy:
    name: str
    adapter_kind: str
    trainable: Tuple[str, ...]
    two_stage: bool = False
    adapter_position: str = "attn_out"


STRATEGIES = {
    "hadamard": Strategy(
        "hadamard", "hadamard",
        MODULE_PATTERNS["W"] + MODULE_PATTERNS["B"] + MODULE_PATTERNS["N"],
        two_stage=True,
    ),
}


def strategy(name: str) -> Strategy:
    try:
        return STRATEGIES[name]
    except KeyError:
        raise KeyError(f"strategy {name!r} is not ported yet; "
                       f"known: {sorted(STRATEGIES)}")


def attach(cfg: ModelCfg, strat: Strategy) -> ModelCfg:
    """Return a config whose params contain the strategy's adapter."""
    return cfg.replace(
        adapter=AdapterCfg(
            kind=strat.adapter_kind,
            position=strat.adapter_position,
            lora_rank=cfg.adapter.lora_rank,
            houlsby_dim=cfg.adapter.houlsby_dim,
        )
        if strat.adapter_kind != "none"
        else AdapterCfg(kind="none")
    )

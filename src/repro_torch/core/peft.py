"""PEFT strategies (port of `repro.core.peft`): which parameters exist and
which are trainable.

A strategy is (adapter kind, trainable path patterns). The trainer gives
`requires_grad` only to the leaves the strategy's mask selects and keeps
optimizer state only for them.

Patterns are matched against each leaf's JAX path
(`convert.jax_path`: 'blocks/g0/slot0/adapter/w', not 'layers/3/...'), so
one regex selects the same leaves in both packages and `param_stats`
counts what JAX counts.

Stages (paper §3.2):
  stage 1: train only the classification head (pooler + classifier).
  stage 2: reload the head, freeze it, train adapter + FFN-output norm.

The port carries the strategies whose adapter kind is 'none' or
'hadamard'. LoRA, Houlsby and IA3 adapters and per-layer gating
(`layer_gate`) arrive with later slices and raise until then.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

from repro_torch.common import tree as tu
from repro_torch.common.types import AdapterCfg, ModelCfg
from repro_torch.convert import jax_path

HEAD_PATTERNS = (r"^pooler/", r"^classifier/")

# paper Table 4 module names:
#   W = adapter weight, B = adapter bias,
#   N = ffn-output ("post-intermediate") norm, A = attention-output norm
MODULE_PATTERNS = {
    "W": (r"/adapter/w$",),
    "B": (r"/adapter/b$",),
    "N": (r"/ffn_norm/",),
    "A": (r"/attn_norm/",),
}


@dataclass(frozen=True)
class Strategy:
    name: str
    adapter_kind: str  # 'none' | 'hadamard'
    trainable: Tuple[str, ...]
    two_stage: bool = False
    adapter_position: str = "attn_out"


STRATEGIES = {
    "full": Strategy("full", "none", (r".*",)),
    "classifier_only": Strategy("classifier_only", "none", HEAD_PATTERNS),
    # the paper: adapter W+B plus the post-intermediate norm, two-stage
    "hadamard": Strategy(
        "hadamard", "hadamard",
        MODULE_PATTERNS["W"] + MODULE_PATTERNS["B"] + MODULE_PATTERNS["N"],
        two_stage=True,
    ),
    # literal Eq. 7 placement variant (pre-W_O on Concat(heads))
    "hadamard_concat": Strategy(
        "hadamard_concat", "hadamard",
        MODULE_PATTERNS["W"] + MODULE_PATTERNS["B"] + MODULE_PATTERNS["N"],
        two_stage=True, adapter_position="attn_concat",
    ),
    # baselines from paper Table 3
    "bitfit": Strategy(
        "bitfit", "none",
        (r"/b[qkvio]$", r"/bias$", r"_b$", r"_bias$") + HEAD_PATTERNS,
    ),
    "ln_tuning": Strategy(
        "ln_tuning", "none", (r"/ffn_norm/", r"/attn_norm/") + HEAD_PATTERNS
    ),
}

# the JAX registry's other strategies, and the slice that brings them
LATER = {name: "the LoRA/Houlsby/IA3 baselines slice"
         for name in ("lora", "houlsby", "ia3")}


def strategy(name: str) -> Strategy:
    if name in LATER:
        raise NotImplementedError(f"strategy {name!r} is not ported yet; it "
                                  f"arrives with {LATER[name]}")
    try:
        return STRATEGIES[name]
    except KeyError:
        raise KeyError(f"unknown strategy {name!r}; known: "
                       f"{sorted(STRATEGIES)}")


def ablation_strategy(modules: str) -> Strategy:
    """Paper Table 4: e.g. modules='B+N' -> only those unfrozen."""
    pats: Tuple[str, ...] = ()
    for m in modules.split("+"):
        pats = pats + MODULE_PATTERNS[m.strip()]
    return Strategy(f"hadamard[{modules}]", "hadamard", pats, two_stage=True)


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


def trainable_mask(params, strat: Strategy, stage: int = 2, *,
                   cfg: ModelCfg):
    """A tree of bools over `params`: the head in stage 1 of a two-stage
    strategy, else the strategy's patterns. `cfg` names each layer leaf by
    its JAX path."""
    pats = HEAD_PATTERNS if strat.two_stage and stage == 1 else strat.trainable
    return tu.mask_from_patterns(params, pats,
                                 path_of=lambda p: jax_path(p, cfg))


def head_mask(params):
    return tu.mask_from_patterns(params, HEAD_PATTERNS)


def param_stats(params, mask):
    total = tu.count_params(params)
    trainable = tu.count_masked(params, mask)
    return {
        "total": total,
        "trainable": trainable,
        "fraction": trainable / max(total, 1),
        "percent": 100.0 * trainable / max(total, 1),
    }


def layer_gate(*args, **kwargs):
    raise NotImplementedError(
        "per-layer gating (paper Table 5) is not ported yet; it arrives "
        "with the sparse-adapter slice")

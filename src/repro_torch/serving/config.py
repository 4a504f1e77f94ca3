"""One declarative config for the serving surface (port of
`repro.serving.config`).

`ServingConfig` is validated at construction, as JAX's is, and
`make_scheduler` builds the scheduler it describes: the contiguous slot
scheduler, the paged one (`paged`, with prefix sharing and int8/fp8 KV
blocks), or either with speculative decoding (`spec_k`), each reporting
into one MetricsRegistry (`obs`) and, with `slo` (and `admission`),
watched by an SLO monitor (and acted on by the degradation ladder).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from repro_torch.models.attention import DECODE_PAGE
from repro_torch.obs.slo import SLOSpec
from repro_torch.serving.admission import AdmissionConfig

_QUANT_MODES = (None, "int8", "fp8")


@dataclass(frozen=True)
class ServingConfig:
    """Capacity: num_slots concurrent sequences a tick; max_len each
    sequence's cache length (prompt and generation), a multiple of the
    decode page size (16).
    Paged KV: paged (a block pool instead of slot rows), page_size tokens
    a block, num_blocks (None: 1.5x what every slot can reserve, plus the
    null block), prefix_cache (copy-on-write prompt sharing), kv_quant
    ('int8'/'fp8' KV blocks, paged only).
    Speculation: spec_k drafts a tick (0: off); spec_draft 'self' (the
    identity-adapter backbone) or 'model' (make_scheduler's draft_model).
    backbone_quant: the engine's weight quantization make_scheduler
    expects. prefill_bucket: round prompt lengths up to multiples of it.
    top_k/temperature: sampling defaults for launchers building
    requests.
    SLOs: slo, an SLOSpec evaluated over the scheduler's metrics
    (breaches land as registry events); admission, an AdmissionConfig
    acting on breaches with the degradation ladder (needs slo)."""

    num_slots: int = 8
    max_len: int = 512
    paged: bool = False
    page_size: int = 16
    num_blocks: Optional[int] = None
    prefix_cache: bool = True
    kv_quant: Optional[str] = None
    spec_k: int = 0
    spec_draft: str = "self"
    backbone_quant: Optional[str] = None
    prefill_bucket: Optional[int] = None
    top_k: int = 0
    temperature: float = 1.0
    slo: Optional[SLOSpec] = None
    admission: Optional[AdmissionConfig] = None

    def __post_init__(self):
        if self.admission is not None and self.slo is None:
            raise ValueError(
                "admission control needs objectives to act on: set slo= "
                "alongside admission=")
        if self.num_slots < 1:
            raise ValueError("num_slots must be >= 1")
        if self.max_len < 1 or self.max_len % DECODE_PAGE:
            raise ValueError(f"max_len must be a positive multiple of "
                             f"{DECODE_PAGE} (the decode page size); got "
                             f"{self.max_len}")
        if self.kv_quant not in _QUANT_MODES:
            raise ValueError(f"kv_quant must be one of {_QUANT_MODES}")
        if self.backbone_quant not in _QUANT_MODES:
            raise ValueError(f"backbone_quant must be one of {_QUANT_MODES}")
        if self.kv_quant is not None and not self.paged:
            raise ValueError(
                "kv_quant requires paged=True: only the block pool stores "
                "quantized KV")
        if self.paged:
            if self.page_size < 1:
                raise ValueError("page_size must be >= 1")
            if self.max_len % self.page_size:
                raise ValueError(
                    f"max_len {self.max_len} must be a multiple of "
                    f"page_size {self.page_size}")
            if self.num_blocks is not None and self.num_blocks < 2:
                raise ValueError(
                    "num_blocks must be >= 2 (block 0 is the null block)")
            if (self.prefill_bucket is not None
                    and self.prefill_bucket % self.page_size):
                raise ValueError(
                    "prefill_bucket must be a multiple of page_size "
                    "(pages are the unit of insert)")
        elif self.num_blocks is not None:
            raise ValueError("num_blocks requires paged=True")
        if self.spec_k < 0:
            raise ValueError("spec_k must be >= 0 (0 disables speculation)")
        if self.spec_draft not in ("self", "model"):
            raise ValueError("spec_draft must be 'self' or 'model'")
        if self.spec_draft == "model" and not self.spec_k:
            raise ValueError(
                "spec_draft='model' is meaningless with spec_k=0")
        if self.prefill_bucket is not None and self.prefill_bucket < 1:
            raise ValueError("prefill_bucket must be >= 1")
        if self.top_k < 0:
            raise ValueError("top_k must be >= 0")


def _auto_blocks(config: ServingConfig) -> int:
    """The default pool: 1.5x the worst case every slot can reserve at once
    (headroom that keeps the prefix cache useful under full load), plus
    the null block."""
    per_slot = config.max_len // config.page_size
    return 1 + config.num_slots * per_slot * 3 // 2


def make_scheduler(engine, config: ServingConfig, *, draft_model=None,
                   obs=None):
    """The scheduler `config` describes, around `engine`, by JAX's rules.
    draft_model: (cfg, params) for spec_draft='model', refused otherwise.
    An engine built with another backbone quantization than
    `config.backbone_quant` asks for is refused (when the config names
    one). obs: the `repro_torch.obs.MetricsRegistry` to report into
    (launchers pass the one their exporters watch); None gives the
    scheduler a private one, `sched.obs`. `config.slo` (and `admission`)
    are attached to the scheduler's tick (`Scheduler.attach_slo`)."""
    from repro_torch.serving.paged import PagedScheduler
    from repro_torch.serving.scheduler import Scheduler
    from repro_torch.serving.spec import SpecPagedScheduler, SpecScheduler

    if config.backbone_quant is not None \
            and getattr(engine, "quant", None) != config.backbone_quant:
        raise ValueError(
            f"config expects a backbone_quant={config.backbone_quant!r} "
            f"engine but the engine was built with "
            f"quant={getattr(engine, 'quant', None)!r}")
    draft = None
    if config.spec_k:
        if config.spec_draft == "model":
            if draft_model is None:
                raise ValueError(
                    "spec_draft='model' requires draft_model=(cfg, params)")
            draft = draft_model
        elif draft_model is not None:
            raise ValueError(
                "draft_model given but spec_draft='self'; set "
                "spec_draft='model' to use it")
    elif draft_model is not None:
        raise ValueError("draft_model given but spec_k=0")

    common = dict(num_slots=config.num_slots, max_len=config.max_len,
                  prefill_bucket=config.prefill_bucket, obs=obs)
    if config.paged:
        paged = dict(common, page=config.page_size,
                     num_blocks=(config.num_blocks
                                 if config.num_blocks is not None
                                 else _auto_blocks(config)),
                     kv_quant=config.kv_quant,
                     prefix_cache=config.prefix_cache)
        if config.spec_k:
            sched = SpecPagedScheduler(engine, spec_k=config.spec_k,
                                       draft=draft, **paged)
        else:
            sched = PagedScheduler(engine, **paged)
    elif config.spec_k:
        sched = SpecScheduler(engine, spec_k=config.spec_k, draft=draft,
                              **common)
    else:
        sched = Scheduler(engine, **common)
    if config.slo is not None:
        sched.attach_slo(config.slo, admission=config.admission)
    return sched

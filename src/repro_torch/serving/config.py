"""One declarative config for the serving surface (port of
`repro.serving.config`).

The port serves through the contiguous slot scheduler. The switches of the
JAX config that turn on features of later slices (paged, spec_k,
kv_quant, backbone_quant, slo, admission) are kept, and setting any of
them raises `NotImplementedError` naming the slice that brings it.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from repro_torch.models.attention import DECODE_PAGE

# field -> (value that means "off", the slice that brings the feature)
_LATER = {
    "paged": (False, "the paged-KV slice"),
    "spec_k": (0, "the speculative-decoding slice"),
    "kv_quant": (None, "the paged-KV slice (int8 KV blocks)"),
    "backbone_quant": (None, "the quantization slice (dequant_matmul)"),
    "slo": (None, "the observability/admission slice"),
    "admission": (None, "the observability/admission slice"),
}


@dataclass(frozen=True)
class ServingConfig:
    """num_slots: concurrent sequences per tick; max_len: per-sequence
    cache length (prompt + generation), a multiple of the decode page
    size (16); prefill_bucket: round prompt lengths up to multiples of
    this before prefill; top_k/temperature: sampling defaults for
    launchers building requests."""

    num_slots: int = 8
    max_len: int = 512
    paged: bool = False
    kv_quant: Optional[str] = None
    spec_k: int = 0
    backbone_quant: Optional[str] = None
    prefill_bucket: Optional[int] = None
    top_k: int = 0
    temperature: float = 1.0
    slo: Optional[object] = None
    admission: Optional[object] = None

    def __post_init__(self):
        for name, (off, slice_) in _LATER.items():
            if getattr(self, name) != off:
                raise NotImplementedError(
                    f"ServingConfig.{name} is not ported yet: it arrives "
                    f"with {slice_}")
        if self.num_slots < 1:
            raise ValueError("num_slots must be >= 1")
        if self.max_len < 1 or self.max_len % DECODE_PAGE:
            raise ValueError(f"max_len must be a positive multiple of "
                             f"{DECODE_PAGE} (the decode page size); got "
                             f"{self.max_len}")
        if self.prefill_bucket is not None and self.prefill_bucket < 1:
            raise ValueError("prefill_bucket must be >= 1")
        if self.top_k < 0:
            raise ValueError("top_k must be >= 0")


def make_scheduler(engine, config: ServingConfig):
    """The scheduler `config` describes, around `engine`."""
    from repro_torch.serving.scheduler import Scheduler

    return Scheduler(engine, num_slots=config.num_slots,
                     max_len=config.max_len,
                     prefill_bucket=config.prefill_bucket)

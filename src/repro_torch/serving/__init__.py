"""Serving surface of the port: engines, the continuous-batching
schedulers (slot caches or a paged block pool, each with or without
speculative decoding), the adapter registry and hot-swap bank, the
declarative config that builds the scheduler, and the admission ladder
that sheds load to protect the SLOs."""
from repro_torch.serving.admission import (AdmissionConfig,
                                           AdmissionController,
                                           AdmissionShedError)
from repro_torch.serving.config import ServingConfig, make_scheduler
from repro_torch.serving.engine import MultiTaskEngine, ServeEngine
from repro_torch.serving.registry import (AdapterBank, AdapterRegistry,
                                          BankFullError)
from repro_torch.serving.scheduler import (Completion, Request, Scheduler,
                                           format_report)
from repro_torch.serving.paged import (BlockAllocator, BlockPoolFullError,
                                       PagedScheduler, PrefixCache)
from repro_torch.serving.spec import (DraftLane, SpecPagedScheduler,
                                      SpecScheduler)

__all__ = ["AdapterBank", "AdapterRegistry", "AdmissionConfig",
           "AdmissionController", "AdmissionShedError", "BankFullError",
           "BlockAllocator", "BlockPoolFullError", "Completion", "DraftLane",
           "MultiTaskEngine", "PagedScheduler", "PrefixCache", "Request",
           "Scheduler", "ServeEngine", "ServingConfig", "SpecPagedScheduler",
           "SpecScheduler", "format_report", "make_scheduler"]

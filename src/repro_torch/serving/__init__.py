"""Serving surface of the port: engines, the continuous-batching
scheduler, and the declarative config that builds it."""
from repro_torch.serving.config import ServingConfig, make_scheduler
from repro_torch.serving.engine import MultiTaskEngine, ServeEngine
from repro_torch.serving.scheduler import (Completion, Request, Scheduler,
                                           format_report)

__all__ = ["Completion", "MultiTaskEngine", "Request", "Scheduler",
           "ServeEngine", "ServingConfig", "format_report", "make_scheduler"]

"""Serving on PyTorch (counterpart of ``repro/serving``): SLO admission, the
LM waves and the continuous exemplar, aggregate and LM slot loops."""
from repro_torch.serving.admission import AdmissionController, AdmissionPolicy, AdmissionStats
from repro_torch.serving.engine import (
    AggregateRequest, ExemplarRequest, Request, ServeEngine, SlotScheduler,
)

__all__ = [
    "AdmissionController", "AdmissionPolicy", "AdmissionStats", "AggregateRequest",
    "ExemplarRequest", "Request", "ServeEngine", "SlotScheduler",
]

"""Serving of the port: the slot-based continuous-batching engine."""

from repro_torch.serving.engine import (  # noqa: F401
    CensusWatch,
    Request,
    ServingEngine,
)

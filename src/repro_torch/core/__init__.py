from repro_torch.core.topology import (
    ContentEvent,
    Grouping,
    Processor,
    Stream,
    Topology,
    TopologyBuilder,
)
from repro_torch.core.engines import JitEngine, LocalEngine, StreamEngine

__all__ = [
    "ContentEvent",
    "Grouping",
    "Processor",
    "Stream",
    "Topology",
    "TopologyBuilder",
    "LocalEngine",
    "JitEngine",
    "StreamEngine",
]

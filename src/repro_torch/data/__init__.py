from repro_torch.data.generators import (
    RandomTreeGenerator,
    RandomTweetGenerator,
    WaveformGenerator,
    ElectricityLikeGenerator,
    CovtypeLikeGenerator,
    bin_numeric,
)
from repro_torch.data.pipeline import Chunk, ChunkedStream, StreamPipeline

__all__ = [
    "Chunk",
    "ChunkedStream",
    "RandomTreeGenerator",
    "RandomTweetGenerator",
    "WaveformGenerator",
    "ElectricityLikeGenerator",
    "CovtypeLikeGenerator",
    "bin_numeric",
    "StreamPipeline",
]

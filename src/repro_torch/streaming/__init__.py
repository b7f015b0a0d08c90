"""Streaming distributed PCA in PyTorch (counterpart of
``repro.streaming``): online banded covariance, drift-triggered refresh
scheduler, compression (full-precision or quantized scores) and detection
stages, chunked drivers with the fused or the split stage body."""

from repro_torch.streaming.compressor import CompressionConfig
from repro_torch.streaming.detector import DetectionConfig
from repro_torch.streaming.driver import (RoundMetrics, StreamConfig,
                                          StreamState, chunk_stream_step,
                                          chunked_stream_run,
                                          fleet_chunk_step, stream_init)

__all__ = ["CompressionConfig", "DetectionConfig", "RoundMetrics",
           "StreamConfig", "StreamState", "chunk_stream_step",
           "chunked_stream_run", "fleet_chunk_step", "stream_init"]

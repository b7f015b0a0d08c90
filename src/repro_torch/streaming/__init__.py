"""Streaming distributed PCA in PyTorch (counterpart of
``repro.streaming``): online banded covariance, drift-triggered refresh
scheduler, compression (full-precision or quantized scores) and detection
stages, per-round and chunked drivers (the chunk body fused or split),
single-network and fleet."""

from repro_torch.streaming.compressor import CompressionConfig
from repro_torch.streaming.detector import DetectionConfig
from repro_torch.streaming.driver import (RoundMetrics, StreamConfig,
                                          StreamState, batched_stream_init,
                                          batched_stream_run,
                                          chunk_stream_step,
                                          chunked_stream_run,
                                          fleet_chunk_step, fleet_round_step,
                                          stream_init, stream_run,
                                          stream_step)

__all__ = ["CompressionConfig", "DetectionConfig", "RoundMetrics",
           "StreamConfig", "StreamState", "batched_stream_init",
           "batched_stream_run", "chunk_stream_step", "chunked_stream_run",
           "fleet_chunk_step", "fleet_round_step", "stream_init",
           "stream_run", "stream_step"]

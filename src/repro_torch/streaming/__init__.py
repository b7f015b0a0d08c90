"""Streaming distributed PCA in PyTorch (counterpart of
``repro.streaming``): online banded covariance, drift-triggered refresh
scheduler, compression (full-precision or quantized scores) and detection
stages, per-round and chunked drivers (the chunk body fused or split),
single-network and fleet, and the two-level fleet merge over
``torch.distributed`` ranks."""

from repro_torch.streaming.compressor import CompressionConfig
from repro_torch.streaming.detector import DetectionConfig
from repro_torch.streaming.driver import (RoundMetrics, StreamConfig,
                                          StreamState, batched_stream_init,
                                          batched_stream_run,
                                          chunk_stream_step,
                                          chunked_stream_run,
                                          fleet_chunk_step, fleet_round_step,
                                          sharded_stream_run, stream_init,
                                          stream_run, stream_step)
from repro_torch.streaming.hierarchy import (FleetBasis, FleetMerge,
                                             fleet_basis_dense,
                                             hierarchical_stream_init,
                                             hierarchical_stream_run,
                                             merge_fleet, region_energies)

__all__ = ["CompressionConfig", "DetectionConfig", "FleetBasis",
           "FleetMerge", "RoundMetrics", "StreamConfig", "StreamState",
           "batched_stream_init", "batched_stream_run", "chunk_stream_step",
           "chunked_stream_run", "fleet_basis_dense", "fleet_chunk_step",
           "fleet_round_step", "hierarchical_stream_init",
           "hierarchical_stream_run", "merge_fleet", "region_energies",
           "sharded_stream_run", "stream_init", "stream_run", "stream_step"]

"""The paper's pipeline (counterpart of ``repro.core``), in PyTorch.

topology, faults, events, compression, spatiotemporal, costs
                 copies of the reference's numpy modules
aggregation      the routing-tree simulator (copied) and the D/A/F
                 collectives and halo exchange over ``torch.distributed``
covariance       streaming covariance (masked dense + banded layouts)
power_iteration  Algorithms 1-2 and the blocked orthogonal iteration
pca              ``DistributedPCA``: fit/transform orchestrator
production       the steps at wsn-1m's width; the iteration steps sharded

Nothing is imported here: ``from repro_torch.core.pca import
DistributedPCA`` (the kernels' plain versions import ``covariance``, and
``pca`` imports the kernels).
"""

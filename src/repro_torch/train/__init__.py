"""Training substrate: optimizer, trainer loop, fault-tolerant checkpoints
(counterpart of ``repro.train``)."""

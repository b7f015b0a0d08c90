"""Fleet sharding over ``torch.distributed`` ranks (counterpart of the
streaming half of ``repro.distributed``)."""

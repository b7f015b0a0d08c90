"""The sharding plan (the LM's FSDP + TP rules as DTensor placements, the
fleet's axes over ranks) and gradient compression (counterpart of
``repro.distributed``, but for ``pipeline``)."""

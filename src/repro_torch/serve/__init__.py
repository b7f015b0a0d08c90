"""Serving front end of the port: the streaming-PCA fleet engine, its
admission queue and its telemetry (counterpart of ``repro.serve``)."""

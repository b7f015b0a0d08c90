"""Data pipelines: deterministic resumable token streams (counterpart of
``repro.data``)."""

"""Copies of ``repro.runtime.health`` and ``repro.runtime.elastic``."""

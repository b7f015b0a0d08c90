"""Copies of the pure-Python parts of ``repro.core`` the port needs."""

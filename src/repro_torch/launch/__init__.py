"""Process-group layout of the fleet (counterpart of ``repro.launch``'s
fleet mesh)."""

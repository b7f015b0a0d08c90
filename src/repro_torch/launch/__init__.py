"""Meshes, the dry run and the roofline plan (counterpart of
``repro.launch``): ``mesh``, ``dryrun``, ``collectives``, ``analytic``,
``roofline``, ``inspect_collectives``, ``tiling``."""

"""Program contracts for the port (counterpart of ``repro.analysis``).

The structural claims the port's speed and correctness rest on — kernel
launches per chunk body, no host sync in the hot loop but at named sites,
fp32 state, collectives per run, state updated in place, one pass over
HBM per launch — checked by machine instead of by hand:

* :mod:`.op_lint` — the op recorder (an entry point run once under a
  ``TorchDispatchMode``, with the port's launch, collective and host-read
  counters) and the rule vocabulary;
* :mod:`.contracts` — the registry; the records live beside the hot paths
  (``streaming/driver.py``, ``streaming/hierarchy.py``,
  ``serve/engine.py``) and register at import;
* :mod:`.resources` — the kernels' work model and bounds (CPU), and the
  build's and launches' bill on the card against the H100's limits and
  the committed ``baselines/resources.json``;
* :mod:`.repolint` — AST lints over ``src/repro_torch/``;
* :mod:`.check` — ``python -m repro_torch.analysis.check`` runs them all.

Nothing here imports the port's entry points at import time.
"""

"""Quickstart: the paper's full WSN pipeline on the Berkeley surrogate
(counterpart of ``examples/quickstart.py``).

1. build the sensor network (52 nodes, 10 m radio, routing tree),
2. estimate the covariance under the local covariance hypothesis,
3. extract principal components with the distributed power iteration,
4. compress measurements via in-network principal component aggregation,
5. compare network loads against the default (send-everything) scheme.

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""

from __future__ import annotations

import numpy as np

from repro_torch.core import costs
from repro_torch.core.compression import (SupervisedCompressor,
                                          scores_in_network)
from repro_torch.core.pca import DistributedPCA, retained_variance
from repro_torch.core.topology import build_topology
from repro_torch.device import resolve_device
from repro_torch.examples import parse_device
from repro_torch.sensors.dataset import berkeley_surrogate, kfold_blocks

P, N_EPOCHS, Q = 52, 7200, 5
RADIO = 10.0
EPSILON = 0.5            # supervised compression's guarantee, degrees C
COMPRESS_EPOCHS = 1000   # held-out epochs through the compressor
LOAD_QS = (1, 5, 15, 20)


def fit(train, topo, device, init=None):
    """Distributed PCA under the local covariance hypothesis: the masked
    covariance and the deflated power iteration (Algorithm 2), q = 5;
    ``init`` (q, p) the initial vectors (drawn from seed 0 when None)."""
    return DistributedPCA(q=Q, method="power", t_max=30, delta=1e-3,
                          cov_mode="masked",
                          mask=np.asarray(topo.covariance_mask()),
                          init=init, device=device).fit(train)


def evaluate(res, topo, test, compress_epochs=COMPRESS_EPOCHS) -> dict:
    """Steps 4 and 5 on a fit: the valid components, their held-out
    retained variance, PCAg's in-network scores of the first held-out
    epoch with its packets per node, supervised compression (ε = 0.5 C)
    over the first ``compress_epochs`` held-out epochs (None: all), and
    the load table."""
    kept = res.components[:, res.valid]
    z, packets = scores_in_network(topo.tree, kept, test[0], mean=res.mean)
    block = test[:compress_epochs]
    out = SupervisedCompressor(kept, res.mean, epsilon=EPSILON).run(block)
    c_max = int(topo.tree.children_counts().max())
    return dict(
        kept=kept, retained=retained_variance(test, kept, res.mean),
        scores=z, packets=packets,
        notification_rate=float(out.flagged.mean()),
        max_sink_error=float(np.abs(out.x_hat - block).max()),
        loads=[(q, costs.pcag_epoch_load(q, c_max),
                costs.pcag_beats_default(q, 6, P)) for q in LOAD_QS],
        default_load=costs.default_epoch_load(P))


def run(device="cuda", *, init=None) -> dict:
    """The whole pipeline; returns the topology's figures, the fit (numpy
    fields) and :func:`evaluate`'s numbers."""
    device = resolve_device(device)
    data = berkeley_surrogate(p=P, n_epochs=N_EPOCHS, seed=0)
    tr, te = kfold_blocks(data.n_epochs, k=10)[0]
    train, test = data.measurements[tr], data.measurements[te]
    topo = build_topology(data.positions, radio_range=RADIO)
    res = fit(train, topo, device, init)
    return dict(evaluate(res, topo, test), fit=res,
                tree_depth=int(topo.tree.depth.max()),
                max_children=int(topo.tree.children_counts().max()),
                max_neighborhood=int(topo.neighborhood_sizes().max()))


def main(argv=None) -> None:
    device = parse_device(__doc__, argv)
    print("=== Distributed PCA for WSN: quickstart ===\n")
    r = run(device)
    print(f"network: p={P}, radio 10 m, tree depth {r['tree_depth']}, max "
          f"children {r['max_children']}, max neighborhood "
          f"{r['max_neighborhood']}")
    print(f"\ndistributed PCA: {r['kept'].shape[1]} components kept, "
          f"retained variance on held-out data = {r['retained']:.1%}")
    print(f"eigenvalues: {np.round(r['fit'].eigenvalues, 2)}")
    print(f"\nPCAg epoch: scores {np.round(r['scores'], 2)}")
    print(f"  packets/node: max {r['packets'].max()} "
          f"(default scheme root load: {r['default_load']})")
    print(f"\nsupervised compression (eps=0.5 C): notification rate "
          f"{r['notification_rate']:.1%}, max sink error "
          f"{r['max_sink_error']:.3f} C")
    print("\nload comparison (packets/epoch, highest-loaded node):")
    for q, load, wins in r["loads"]:
        print(f"  PCAg q={q:2d}: {load:4d}   {'wins' if wins else 'loses'}"
              f" vs default {r['default_load']}")


if __name__ == "__main__":
    main()

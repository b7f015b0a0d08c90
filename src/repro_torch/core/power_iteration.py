"""Power iteration method (counterpart of ``repro.core.power_iteration``:
paper Sec. 3.4, Algorithms 1-3), in PyTorch.

* :func:`power_iteration` — Algorithm 1: repeated ``v <- C v / ||C v||``
  with the dual stopping rule (at most ``t_max`` iterations, update norm
  above ``delta``), and the inner loop of Algorithm 2 when
  ``orthogonal_to`` is given.
* :func:`deflated_power_iteration` — Algorithm 2: q components by
  deflation, with the sign criterion ``sign(sum_i sign(v_t[i] v_{t+1}[i]))``
  for negative eigenvalues.
* :func:`orthogonal_iteration` — the blocked subspace iteration (beyond
  the paper): ``V <- C V``, one Gram matrix a step, a small replicated
  Cholesky.

Every global reduction goes through an ``aggregate`` callable (identity on
one process, :func:`repro_torch.core.aggregation.a_op` over a process
group, or the routing-tree simulator), as in the reference.

The reference's ``lax.while_loop`` is a host loop here: the loop test
``t < t_max and d > delta`` is decided on the device in the iterate's
dtype and read by the host after every iteration but the last of
``t_max`` — the one host read of the loop, counted in :data:`HOST_READS`
under the function's name.  Under ``torch.profiler`` each step of
:func:`orthogonal_iteration` is the span ``repro_torch.ortho.step`` and
each counted read the span ``repro_torch.stop_test``
(:mod:`repro_torch.spans`).  The
reference draws its initial vectors from ``jax.random``, which torch
cannot reproduce: they are arguments here (``v0``), drawn from a seeded
``torch.Generator`` when not given.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.device import as_tensor, resolve_device
from repro_torch.spans import span

__all__ = [
    "PowerIterResult", "power_iteration", "eigenvalue_sign",
    "DeflationResult", "deflated_power_iteration",
    "orthogonal_iteration", "OrthoIterResult", "orthonormalize",
    "HOST_READS", "reset_host_reads",
]

# the iterations' loops (checked by repolint's host-pull rule): the one
# host read a step is the counted stopping test
HOT_PATHS = ("_keep_going", "eigenvalue_sign", "power_iteration",
             "deflated_power_iteration", "orthonormalize",
             "orthogonal_iteration")

Aggregate = Callable[[torch.Tensor], torch.Tensor]

# host reads by where they happen: the loop tests of the two iterations,
# and the scheduler's refresh (its eigh's check, one a decision)
HOST_READS = {"power_iteration": 0, "orthogonal_iteration": 0,
              "ortho_refresh_evals": 0}


def reset_host_reads() -> None:
    for k in HOST_READS:
        HOST_READS[k] = 0


def _identity_aggregate(x: torch.Tensor) -> torch.Tensor:
    return x


def _keep_going(t: int, t_max: int, d: torch.Tensor, delta: float,
                name: str) -> bool:
    """The loop test ``t < t_max and d > delta``.  Before the first
    iteration ``d`` is infinite and nothing is read; after it, ``d >
    delta`` is compared on the device in ``d``'s dtype (as the reference
    compares it) and read by the host: at most one counted read an
    iteration, none after the last of ``t_max``."""
    if t >= t_max:
        return False
    if t == 0:
        return True
    HOST_READS[name] += 1
    # the iteration's layer: the counted read alone
    with span("repro_torch.stop_test"):
        # repolint: allow-host-pull the loop's one counted read a step
        return bool(d > delta)


def _normal(shape, dtype, device, generator) -> torch.Tensor:
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    return torch.randn(shape, dtype=dtype, device=device,
                       generator=generator)


class PowerIterResult(NamedTuple):
    v: torch.Tensor           # (p,) eigenvector estimate (unit norm)
    eigenvalue: torch.Tensor  # () signed eigenvalue estimate
    iterations: int           # iterations run
    delta: torch.Tensor       # () final update norm ||v_{t+1} - v_t||


def eigenvalue_sign(v_prev: torch.Tensor, v_next: torch.Tensor,
                    aggregate: Aggregate = _identity_aggregate,
                    ) -> torch.Tensor:
    """The paper's sign criterion: sign(sum_i sign(v_t[i] v_{t+1}[i])),
    the local partial sums summed by ``aggregate`` (an A operation)."""
    return torch.sign(aggregate(torch.sign(v_prev * v_next).sum()))


def power_iteration(matvec: Callable[[torch.Tensor], torch.Tensor],
                    v0: torch.Tensor, t_max: int = 50, delta: float = 1e-3,
                    aggregate: Aggregate = _identity_aggregate,
                    orthogonal_to: torch.Tensor | None = None,
                    ) -> PowerIterResult:
    """Algorithm 1 (and the inner loop of Algorithm 2 when
    ``orthogonal_to``, a (p, k) matrix of earlier eigenvectors, is given).

    ``matvec`` computes ``C v`` (any neighbour exchange happens inside);
    ``v0`` must not be orthogonal to the principal eigenvector.  The
    arithmetic of an iteration is the reference's, operation for
    operation; its update norm ``d`` is measured against the sign-aligned
    vector, so a negative eigenvalue's oscillation does not mask
    convergence."""
    W = orthogonal_to
    if W is not None and W.shape[1] == 0:
        W = None

    def project_out(v):
        if W is None:
            return v
        # k-1 dot products: one A op with a vector-valued partial record
        return v - W @ aggregate(W.T @ v)

    def norm(v):
        return torch.sqrt(aggregate((v * v).sum()))

    v = v0 / norm(v0).clamp(min=1e-30)
    lam = torch.zeros((), dtype=v0.dtype, device=v0.device)
    d = torch.full((), float("inf"), dtype=v0.dtype, device=v0.device)
    t = 0
    while _keep_going(t, t_max, d, delta, "power_iteration"):
        cv = project_out(matvec(v))
        nrm = norm(cv)
        v_next = cv / nrm.clamp(min=1e-30)
        sign = eigenvalue_sign(v, v_next, aggregate)
        d = torch.sqrt(aggregate(((v_next * sign - v) ** 2).sum()))
        v, lam, t = v_next, sign * nrm, t + 1
    return PowerIterResult(v=v, eigenvalue=lam, iterations=t, delta=d)


class DeflationResult(NamedTuple):
    W: torch.Tensor            # (p, q) estimates, column k = w_{k+1}
    eigenvalues: torch.Tensor  # (q,) signed eigenvalue estimates
    valid: torch.Tensor        # (q,) bool — False from the first negative
    iterations: torch.Tensor   # (q,) int32 iterations used per component


def deflated_power_iteration(matvec: Callable[[torch.Tensor], torch.Tensor],
                             p: int, q: int, v0: torch.Tensor | None = None,
                             t_max: int = 50, delta: float = 1e-3,
                             aggregate: Aggregate = _identity_aggregate,
                             dtype=torch.float32, device="cuda",
                             generator: torch.Generator | None = None,
                             ) -> DeflationResult:
    """Algorithm 2: q components by deflation and the sign criterion.

    ``v0`` (q, p): row k starts component k (the reference draws it as
    ``jax.random.normal(split(key, q)[k], (p,))``); None draws it from
    ``generator`` (a seeded one when None).  Components at or after the
    first negative eigenvalue are flagged invalid (Sec. 3.3.1)."""
    dev = resolve_device(device)
    if v0 is None:
        v0 = _normal((q, p), dtype, dev, generator)
    v0 = as_tensor(v0, dtype, dev)
    W = torch.zeros((p, q), dtype=dtype, device=dev)
    lams = torch.zeros((q,), dtype=dtype, device=dev)
    valid = torch.ones((q,), dtype=torch.bool, device=dev)
    iters = []
    alive = torch.ones((), dtype=torch.bool, device=dev)
    for k in range(q):
        res = power_iteration(matvec, v0[k], t_max=t_max, delta=delta,
                              aggregate=aggregate, orthogonal_to=W[:, :k])
        W[:, k] = res.v
        lams[k] = res.eigenvalue
        iters.append(res.iterations)
        alive = alive & (res.eigenvalue > 0)
        valid[k] = alive
    return DeflationResult(W=W, eigenvalues=lams, valid=valid,
                           iterations=torch.tensor(iters, dtype=torch.int32))


class OrthoIterResult(NamedTuple):
    W: torch.Tensor            # (p, q) orthonormal basis, Rayleigh-ordered
    eigenvalues: torch.Tensor  # (q,) Rayleigh-quotient eigenvalue estimates
    iterations: int            # iterations run


def orthonormalize(V: torch.Tensor, gram: torch.Tensor,
                   eps: float = 1e-8) -> torch.Tensor:
    """``V inv(L)^T`` with ``L = chol(gram + eps I)`` over any leading
    axes: the reference's replicated-Cholesky step, ``inv(L)`` as a
    triangular solve against the identity.  ``gram`` is ``V^T V``, summed
    over the ranks where V is sharded.  The ``_ex`` and triangular-solve
    forms raise nothing, so nothing syncs with the host."""
    q = V.shape[-1]
    eye = torch.eye(q, dtype=V.dtype, device=V.device)
    L = torch.linalg.cholesky_ex(gram + eps * eye).L
    Linv = torch.linalg.solve_triangular(L, eye.expand_as(L), upper=False)
    return V @ Linv.mT


def orthogonal_iteration(matmul: Callable[[torch.Tensor], torch.Tensor],
                         p: int, q: int, v0: torch.Tensor | None = None,
                         t_max: int = 50, delta: float = 1e-3,
                         aggregate: Aggregate = _identity_aggregate,
                         dtype=torch.float32, eps: float = 1e-8,
                         device="cuda",
                         generator: torch.Generator | None = None,
                         ) -> OrthoIterResult:
    """Blocked subspace iteration (beyond the paper).

    One iteration: ``V <- C V``; the Gram matrix ``G = V^T V`` (ONE
    aggregation of a q x q record); ``V <- V chol(G)^{-T}``.  After
    convergence the small Rayleigh problem ``H = V^T (C V)`` is solved
    (replicated) to order the basis.  ``v0`` (p, q) is the start (the
    reference's ``jax.random.normal(key, (p, q))``); None draws it from
    ``generator``.  ``t_max`` + 1 products at most."""
    dev = resolve_device(device)
    if v0 is None:
        v0 = _normal((p, q), dtype, dev, generator)
    v0 = as_tensor(v0, dtype, dev)

    def step(V):
        return orthonormalize(V, aggregate(V.T @ V), eps)

    V = step(v0)
    d = torch.full((), float("inf"), dtype=dtype, device=dev)
    t = 0
    while _keep_going(t, t_max, d, delta, "orthogonal_iteration"):
        # the iteration's layer: one step, the stopping test apart
        with span("repro_torch.ortho.step"):
            V_next = step(matmul(V))
            # subspace distance proxy: per-column update norm after sign
            # alignment (the sign from the local sums, as in the reference)
            sign = torch.sign((V * V_next).sum(0))
            d = torch.sqrt(aggregate(((V_next * sign - V) ** 2).sum()) / q)
            V, t = V_next, t + 1

    H = aggregate(V.T @ matmul(V))                  # (q, q) Rayleigh matrix
    # jnp.linalg.eigh symmetrizes its input; torch reads one triangle
    # repolint: allow-host-pull eigh of the final Rayleigh matrix, once a fit
    evals, U = torch.linalg.eigh(0.5 * (H + H.T))   # ascending
    order = torch.argsort(-evals, stable=True)
    return OrthoIterResult(W=V @ U[:, order], eigenvalues=evals[order],
                           iterations=t)

"""The port's paper pipeline (``repro_torch.core``, ``repro_torch.sensors``)
against the JAX reference (``repro.core``), on the CPU.

Inputs are made with numpy from a seed and go through both packages in
this process (``repro.core`` imports none of the names that jax 0.9
moved).  The reference's initial vectors are its own ``jax.random``
draws, handed to the port as numpy (``init=``, ``v0=``).
The port runs with ``device="cpu"``, where the kernels' wrappers take
their plain versions.

Tolerances, and why:

* covariance states: the sums ``t`` exactly; ``s``, the band and the
  dense ``S_ij`` rtol 1e-5 / atol 1e-4 (fp32 sums of up to 200 products in
  another order); the estimates atol 1e-4 (rtol 1e-4 banded: ``S_ij/t -
  S_i S_j/t^2`` cancels the means);
* the iterations on a given matrix: eigenvalues rtol 1e-4, components
  |cos| >= 1 - 1e-4, ``valid`` equal, iteration counts equal — where they
  differ, the step that decided lies in the flip band: both sides' update
  norm ``d`` within ``FLIP_BAND`` of ``delta`` (an ulp of ``d`` can turn
  ``d > delta``; see ROADMAP.md's "Expected differences");
* ``DistributedPCA.fit`` on the Berkeley surrogate: eigenvalues rtol 1e-3
  (the fp32 covariance of ~24 C readings cancels its means; the two
  packages sum in other orders), components |cos| >= 1 - 1e-4, the mean
  rtol/atol 1e-6, the total variance rtol 1e-5, ``valid`` and the iteration
  counts equal; at p = 4096 the same;
* the production steps: rtol/atol 1e-5 (atol 1e-4 for the band of a
  batch and for the scores);
* the copied numpy modules: exactly (the same code on the same numbers).
"""

import ast
import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aggregation as r_agg
from repro.core import compression as r_comp
from repro.core import covariance as r_cov
from repro.core import faults as r_faults
from repro.core import pca as r_pca
from repro.core import power_iteration as r_pim
from repro.core import production as r_prod
from repro.core import spatiotemporal as r_st
from repro.core import topology as r_topo
from repro.sensors import dataset as r_data

from repro_torch.convert import cov_state_from_numpy, cov_state_to_numpy
from repro_torch.core import aggregation as agg
from repro_torch.core import compression as comp
from repro_torch.core import covariance as cov
from repro_torch.core import events
from repro_torch.core import faults
from repro_torch.core import pca
from repro_torch.core import power_iteration as pim
from repro_torch.core import production as prod
from repro_torch.core import spatiotemporal as st
from repro_torch.core import topology as topo
from repro_torch.kernels import ops
from repro_torch.sensors import dataset as data

ROOT = Path(__file__).resolve().parents[1]
FLIP_BAND = 1e-6
COS = 1 - 1e-4


def _np(a):
    return np.asarray(a.detach().cpu() if isinstance(a, torch.Tensor) else a)


def _aligned_cos(A, B):
    """|cos| between matching columns of two bases (signs are free)."""
    A, B = np.asarray(A, np.float64), np.asarray(B, np.float64)
    return np.abs((A * B).sum(0)) / (np.linalg.norm(A, axis=0)
                                     * np.linalg.norm(B, axis=0))


def _power_init(seed, p, q):
    """The reference's draws for 'power': normal(split(key, q)[k], (p,))."""
    keys = jax.random.split(jax.random.PRNGKey(seed), q)
    return np.stack([np.asarray(jax.random.normal(k, (p,), jnp.float32))
                     for k in keys])


def _ortho_init(seed, p, q):
    return np.asarray(jax.random.normal(jax.random.PRNGKey(seed), (p, q),
                                        jnp.float32))


def _spectrum_matrix(lam, seed):
    rng = np.random.default_rng(seed)
    Qm, _ = np.linalg.qr(rng.normal(size=(len(lam), len(lam))))
    return ((Qm * np.asarray(lam)) @ Qm.T).astype(np.float32)


@pytest.fixture(scope="module")
def berkeley():
    """A short Berkeley surrogate (the reference's generator, copied), its
    first block-CV fold, the 10 m topology and its RCM band."""
    ds = data.berkeley_surrogate(p=52, n_epochs=2000, seed=0)
    tr, te = data.kfold_blocks(ds.n_epochs, 10)[0]
    net = topo.build_topology(ds.positions, radio_range=10.0)
    perm = topo.bandwidth_reduce(net.adjacency)
    h = topo.graph_bandwidth(net.adjacency, perm)
    return dict(x=ds.measurements[tr], test=ds.measurements[te], topo=net,
                perm=perm, h=h)


# --------------------------------------------------------------------------
class TestCovariance:
    @pytest.mark.parametrize("p,h,n", [(52, 15, 100), (13, 16, 20),
                                       (4096, 8, 64), (65, 0, 9)])
    def test_banded_matches_reference(self, p, h, n):
        """Two batches folded (kernel 6's plain version on the CPU) and
        the estimate; h past p included."""
        rng = np.random.default_rng(p + h)
        xs = [(rng.normal(size=(n, p)) + 3.0).astype(np.float32)
              for _ in range(2)]
        rs, ts = r_cov.banded_init(p, h), cov.banded_init(p, h, device="cpu")
        for x in xs:
            rs = r_cov.banded_update(rs, jnp.asarray(x))
            ts = cov.banded_update(ts, x)
        assert float(ts.t) == float(rs.t) == 2 * n
        np.testing.assert_allclose(_np(ts.s), _np(rs.s), rtol=1e-5,
                                   atol=1e-4)
        np.testing.assert_allclose(_np(ts.band), _np(rs.band), rtol=1e-5,
                                   atol=1e-4)
        np.testing.assert_allclose(_np(cov.banded_estimate(ts)),
                                   _np(r_cov.banded_estimate(rs)),
                                   rtol=1e-4, atol=1e-4)

    @pytest.mark.parametrize("masked", [False, True])
    def test_dense_matches_reference(self, masked):
        rng = np.random.default_rng(3)
        p = 24
        mask = r_cov.mask_from_band(p, 3) if masked else None
        rs, ts = r_cov.cov_init(p, mask=mask), cov.cov_init(p, mask=mask,
                                                            device="cpu")
        for n in (50, 17):
            x = (rng.normal(size=(n, p)) + 2.0).astype(np.float32)
            rs = r_cov.cov_update(rs, jnp.asarray(x))
            ts = cov.cov_update(ts, x)
        assert float(ts.t) == float(rs.t)
        np.testing.assert_array_equal(_np(ts.mask), _np(rs.mask))
        np.testing.assert_allclose(_np(ts.sxy), _np(rs.sxy), rtol=1e-5,
                                   atol=1e-4)
        np.testing.assert_allclose(_np(cov.cov_estimate(ts)),
                                   _np(r_cov.cov_estimate(rs)), atol=1e-4)

    @pytest.mark.parametrize("p,h", [(17, 4), (9, 12), (30, 0)])
    def test_band_layout_helpers(self, p, h):
        rng = np.random.default_rng(p)
        c = rng.normal(size=(p, p)).astype(np.float32)
        np.testing.assert_array_equal(cov.mask_from_band(p, h),
                                      r_cov.mask_from_band(p, h))
        np.testing.assert_array_equal(
            _np(cov.dense_to_band(torch.from_numpy(c), h)),
            _np(r_cov.dense_to_band(jnp.asarray(c), h)))

    @pytest.mark.parametrize("banded", [False, True])
    def test_convert_carries_the_reference_state(self, banded):
        rng = np.random.default_rng(4)
        p, x = 20, rng.normal(size=(30, 20)).astype(np.float32)
        rs = (r_cov.banded_update(r_cov.banded_init(p, 3), jnp.asarray(x))
              if banded else r_cov.cov_update(r_cov.cov_init(p),
                                              jnp.asarray(x)))
        arrays = {f: np.asarray(v) for f, v in zip(rs._fields, rs)
                  if f != "halfwidth"}
        ts = cov_state_from_numpy(arrays, device="cpu", prefix="")
        assert type(ts).__name__ == type(rs).__name__
        est = cov.banded_estimate if banded else cov.cov_estimate
        r_est = r_cov.banded_estimate if banded else r_cov.cov_estimate
        np.testing.assert_allclose(_np(est(ts)), _np(r_est(rs)), atol=1e-6)
        back = cov_state_to_numpy(ts, prefix="s.")
        assert sorted(back) == sorted(f"s.{k}" for k in arrays)
        for k, v in arrays.items():
            np.testing.assert_array_equal(back[f"s.{k}"], v)


# --------------------------------------------------------------------------
def _flip_band_ok(ref_run, port_run, t):
    """Both sides' update norm after ``t`` iterations within FLIP_BAND of
    delta: the stopping test may turn on an ulp there."""
    d_ref, d_port = ref_run(t), port_run(t)
    return abs(d_ref - 1e-3) <= FLIP_BAND and abs(d_port - 1e-3) <= FLIP_BAND


def _reads(iterations, t_max=50):
    """The host reads of the loop test: one after each iteration (the
    last of them finds ``d <= delta``), none after the t_max-th."""
    return sum(min(int(t), t_max - 1) for t in iterations)


class TestIterations:
    @pytest.mark.parametrize("lam,seed", [
        ([5.0, 2.0, 1.0] + [0.1] * 7, 0),
        ([-5.0, 2.0, 1.0] + [0.1] * 7, 1),
        ([3.0, -2.9, 1.0, 0.5] + [0.05] * 12, 2)])
    def test_power_iteration_matches_reference(self, lam, seed):
        """Algorithm 1 from the reference's start: a positive and two
        negative dominant eigenvalues (the sign criterion)."""
        C = _spectrum_matrix(lam, seed)
        p = C.shape[0]
        v0 = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), (p,),
                                          jnp.float32))
        Cj, Ct = jnp.asarray(C), torch.from_numpy(C)
        ref = lambda t: r_pim.power_iteration(lambda v: Cj @ v,
                                              jnp.asarray(v0), t_max=t)
        port = lambda t: pim.power_iteration(
            lambda v: Ct @ v, torch.tensor(v0), t_max=t)
        r, t = ref(50), port(50)
        np.testing.assert_allclose(float(t.eigenvalue), float(r.eigenvalue),
                                   rtol=1e-4)
        assert np.sign(float(t.eigenvalue)) == np.sign(lam[0])
        assert _aligned_cos(_np(t.v)[:, None], _np(r.v)[:, None])[0] >= COS
        if t.iterations != int(r.iterations):
            n = min(t.iterations, int(r.iterations))
            assert _flip_band_ok(lambda k: float(ref(k).delta),
                                 lambda k: float(port(k).delta), n)

    @pytest.mark.parametrize("lam,seed", [
        (10.0 * 0.6 ** np.arange(30), 3),
        ([6.0, 3.0, -2.0, 1.0] + [0.05] * 8, 4)])
    def test_deflated_power_iteration_matches_reference(self, lam, seed):
        """Algorithm 2, q = 5, from the reference's own draws; the second
        spectrum is indefinite, so ``valid`` turns False at the first
        negative eigenvalue."""
        C = _spectrum_matrix(lam, seed)
        p, q = C.shape[0], 5
        Cj, Ct = jnp.asarray(C), torch.from_numpy(C)
        r = r_pim.deflated_power_iteration(lambda v: Cj @ v, p, q,
                                           jax.random.PRNGKey(seed))
        pim.reset_host_reads()
        t = pim.deflated_power_iteration(
            lambda v: Ct @ v, p, q, v0=_power_init(seed, p, q),
            device="cpu")
        np.testing.assert_allclose(_np(t.eigenvalues), _np(r.eigenvalues),
                                   rtol=1e-4)
        assert (_aligned_cos(_np(t.W), _np(r.W)) >= COS).all()
        np.testing.assert_array_equal(_np(t.valid), _np(r.valid))
        np.testing.assert_array_equal(_np(t.iterations), _np(r.iterations))
        assert pim.HOST_READS["power_iteration"] == _reads(t.iterations)

    @pytest.mark.parametrize("p,q,seed", [(40, 4, 5), (64, 8, 6)])
    def test_orthogonal_iteration_matches_reference(self, p, q, seed):
        C = _spectrum_matrix(10.0 * 0.7 ** np.arange(p), seed)
        Cj, Ct = jnp.asarray(C), torch.from_numpy(C)
        r = r_pim.orthogonal_iteration(lambda V: Cj @ V, p, q,
                                       jax.random.PRNGKey(seed))
        pim.reset_host_reads()
        t = pim.orthogonal_iteration(
            lambda V: Ct @ V, p, q,
            v0=_ortho_init(seed, p, q), device="cpu")
        np.testing.assert_allclose(_np(t.eigenvalues), _np(r.eigenvalues),
                                   rtol=1e-4)
        assert (_aligned_cos(_np(t.W), _np(r.W)) >= COS).all()
        assert t.iterations == int(r.iterations)
        assert pim.HOST_READS["orthogonal_iteration"] == _reads([
            t.iterations])

    def test_eigenvalue_sign_and_default_draws(self):
        v = torch.tensor([1.0, -2.0, 3.0])
        assert float(pim.eigenvalue_sign(v, -v)) == -1.0
        assert float(pim.eigenvalue_sign(v, 2 * v)) == 1.0
        C = torch.from_numpy(_spectrum_matrix([4.0, 1.0, 0.5, 0.1], 0))
        a = pim.deflated_power_iteration(lambda u: C @ u, 4, 2,
                                         device="cpu")
        b = pim.deflated_power_iteration(lambda u: C @ u, 4, 2,
                                         device="cpu")
        assert torch.equal(a.W, b.W)          # seeded generator by default

    @pytest.mark.parametrize("t_max,delta", [(50, 1e-3), (3, 0.0)])
    def test_orthogonal_iteration_spans(self, t_max, delta):
        """One ``repro_torch.ortho.step`` span an iteration, and one
        ``repro_torch.stop_test`` span a counted host read (none before
        the first step, none after the last of ``t_max``)."""
        p, q = 40, 4
        C = torch.from_numpy(_spectrum_matrix(10.0 * 0.7 ** np.arange(p),
                                              5))
        pim.reset_host_reads()
        res, events = _profiled(lambda: pim.orthogonal_iteration(
            lambda V: C @ V, p, q, v0=_ortho_init(5, p, q), t_max=t_max,
            delta=delta, device="cpu"))
        names = [e.name for e in events]
        assert res.iterations > 1
        assert names.count("repro_torch.ortho.step") == res.iterations
        assert names.count("repro_torch.stop_test") == (
            pim.HOST_READS["orthogonal_iteration"])
        assert pim.HOST_READS["orthogonal_iteration"] == _reads(
            [res.iterations], t_max)


def _profiled(fn):
    """``fn()`` under a CPU ``torch.profiler`` session, and its events."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, sorted(prof.events(), key=lambda e: e.time_range.start)


# --------------------------------------------------------------------------
def _fit_pair(kw, x, seed=0):
    """The reference's fit and the port's from the reference's draws."""
    p, q = x.shape[1], kw["q"]
    init = {"power": _power_init(seed, p, q),
            "ortho": _ortho_init(seed, p, q)}.get(kw["method"])
    r = r_pca.DistributedPCA(seed=seed, **kw).fit(x)
    t = pca.DistributedPCA(seed=seed, init=init, device="cpu", **kw).fit(x)
    return r, t


def _check_fit(r, t):
    np.testing.assert_allclose(t.eigenvalues, r.eigenvalues, rtol=1e-3)
    assert (_aligned_cos(t.components, r.components) >= COS).all()
    np.testing.assert_allclose(t.mean, r.mean, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(t.total_variance, r.total_variance,
                               rtol=1e-5)
    np.testing.assert_array_equal(t.valid, r.valid)
    np.testing.assert_array_equal(np.asarray(t.iterations),
                                  np.asarray(r.iterations))
    assert t.components.dtype == np.float64 and t.valid.dtype == bool


class TestDistributedPCA:
    @pytest.mark.parametrize("method", ["eigh", "power", "ortho"])
    @pytest.mark.parametrize("mode", ["full", "masked", "banded"])
    def test_fit_matches_reference_berkeley(self, berkeley, method, mode):
        """Every method x covariance mode on the surrogate's first fold
        (p = 52, q = 5): masked with the 10 m neighbourhoods, banded on the
        RCM relabelling with h = its graph bandwidth."""
        x = berkeley["x"]
        kw = dict(q=5, method=method, cov_mode=mode)
        if mode == "masked":
            kw["mask"] = berkeley["topo"].covariance_mask()
        if mode == "banded":
            kw["halfwidth"] = berkeley["h"]
            x = x[:, berkeley["perm"]]
        ops.reset_counts()
        r, t = _fit_pair(kw, x)
        _check_fit(r, t)
        # on the CPU the banded products take their plain versions
        want = dict.fromkeys(ops.PLAIN_CALLS, 0)
        if mode == "banded":
            want["band_round"] = 1
            if method == "power":
                want["banded_matvec"] = int(t.iterations.sum())
            if method == "ortho":
                want["banded_matmul"] = int(t.iterations) + 1
        assert ops.PLAIN_CALLS == want and not any(ops.LAUNCHES.values())

    @pytest.mark.parametrize("method", ["power", "ortho"])
    def test_fit_banded_wsn_smoke_width(self, method):
        """The banded fit at WSNConfig.smoke()'s width: p = 4096, h = 8,
        q = 8, on a field of local modes narrower than the band."""
        rng = np.random.default_rng(11)
        p, h, q, n = 4096, 8, 8, 256
        j = np.arange(p)
        centres = np.linspace(0.05, 0.95, 24) * p
        U = np.exp(-0.5 * ((j[:, None] - centres[None, :]) / 1.5) ** 2)
        U /= np.linalg.norm(U, axis=0)
        g = rng.normal(size=(n, 24)) * (3.0 * 0.85 ** np.arange(24))
        x = (g @ U.T + 0.05 * rng.normal(size=(n, p))).astype(np.float32)
        r, t = _fit_pair(dict(q=q, method=method, cov_mode="banded",
                              halfwidth=h), x)
        _check_fit(r, t)

    def test_entry_points_default_to_cuda_and_never_fall_back(
            self, monkeypatch):
        """Without a card, asking for the default device raises: nothing
        runs on the CPU unless the caller asks for it."""
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        x = np.ones((4, 3), np.float32)
        for call in (lambda: pca.DistributedPCA(q=1).fit(x),
                     lambda: cov.banded_init(3, 1),
                     lambda: cov.cov_init(3),
                     lambda: pim.deflated_power_iteration(
                         lambda v: v, 3, 1)):
            with pytest.raises(RuntimeError, match="device='cpu'"):
                call()

    def test_fit_rejects_missing_mask_and_halfwidth(self):
        with pytest.raises(ValueError, match="mask"):
            pca.DistributedPCA(q=2, cov_mode="masked")
        with pytest.raises(ValueError, match="halfwidth"):
            pca.DistributedPCA(q=2, cov_mode="banded")

    def test_numpy_oracles_on_the_port(self, berkeley):
        """The copied oracles run unchanged on the port's PCAResult:
        retained variance, transform / inverse, supervised compression
        (its eps guarantee), the low-variance detector and the
        spatiotemporal PCA, each equal to the reference's on its own fit
        to the fit's tolerance."""
        x, test = berkeley["x"], berkeley["test"][:500]
        mask = berkeley["topo"].covariance_mask()
        kw = dict(q=5, method="eigh", cov_mode="masked", mask=mask)
        r, t = _fit_pair(kw, x)
        np.testing.assert_allclose(
            pca.retained_variance(test, t.components, t.mean),
            r_pca.retained_variance(test, r.components, r.mean), rtol=1e-5)
        sgn = np.sign((t.components * r.components).sum(0))
        z_t = pca.DistributedPCA.transform(t, test)
        z_r = r_pca.DistributedPCA.transform(r, test)
        np.testing.assert_allclose(z_t * sgn, z_r, atol=2e-3)
        np.testing.assert_allclose(
            pca.DistributedPCA.inverse_transform(t, z_t),
            r_pca.DistributedPCA.inverse_transform(r, z_r), atol=2e-3)
        out = comp.SupervisedCompressor(t.components, t.mean, 0.5).run(test)
        assert np.abs(out.x_hat - test).max() <= 0.5
        det = events.LowVarianceDetector(t.components[:, 3:],
                                         t.eigenvalues[3:], t.mean)
        assert det.detect(test).events.shape == (len(test),)
        st_t = st.SpatioTemporalPCA(q=3, window=2, spatial_mask=mask,
                                    device="cpu").fit(x)
        st_r = r_st.SpatioTemporalPCA(q=3, window=2, spatial_mask=mask) \
            .fit(x)
        np.testing.assert_allclose(st_t.eigenvalues, st_r.eigenvalues,
                                   rtol=1e-3)


# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def wsn_smoke():
    """WSNConfig.smoke()'s width: p = 4096, h = 8, q = 8, 8-epoch batches;
    a banded covariance from a seeded field, the iterates."""
    rng = np.random.default_rng(12)
    p, h, q, n = 4096, 8, 8, 8
    x = rng.normal(size=(64, p)).astype(np.float32)
    x[:, 1:] += 0.5 * x[:, :-1]
    band = _np(cov.banded_estimate(cov.banded_update(
        cov.banded_init(p, h, device="cpu"), x)))
    return dict(p=p, h=h, q=q, band=band,
                batch=rng.normal(size=(n, p)).astype(np.float32),
                v=rng.normal(size=p).astype(np.float32),
                V=np.linalg.qr(rng.normal(size=(p, q)))[0].astype(np.float32),
                mean=rng.normal(size=p).astype(np.float32))


class TestProduction:
    def test_cov_update_step(self, wsn_smoke):
        s = wsn_smoke
        r = r_prod.cov_update_step(r_cov.banded_init(s["p"], s["h"]),
                                   jnp.asarray(s["batch"]))
        t = prod.cov_update_step(cov.banded_init(s["p"], s["h"],
                                                 device="cpu"), s["batch"])
        assert float(t.t) == float(r.t)
        np.testing.assert_allclose(_np(t.s), _np(r.s), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(_np(t.band), _np(r.band), rtol=1e-4,
                                   atol=1e-4)

    def test_pim_block_step(self, wsn_smoke):
        s = wsn_smoke
        rv, rl = r_prod.pim_block_step(jnp.asarray(s["band"]),
                                       jnp.asarray(s["V"]))
        tv, tl = prod.pim_block_step(torch.from_numpy(s["band"]),
                                     torch.from_numpy(s["V"]))
        np.testing.assert_allclose(_np(tv), _np(rv), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(_np(tl), _np(rl), rtol=1e-5, atol=1e-5)

    @pytest.mark.parametrize("k", [0, 3])
    def test_pim_deflated_step(self, wsn_smoke, k):
        s = wsn_smoke
        W = s["V"][:, :k]
        rv, rl = r_prod.pim_deflated_step(jnp.asarray(s["band"]),
                                          jnp.asarray(s["v"]),
                                          jnp.asarray(W))
        tv, tl = prod.pim_deflated_step(torch.from_numpy(s["band"]),
                                        torch.from_numpy(s["v"]),
                                        torch.from_numpy(W))
        np.testing.assert_allclose(_np(tv), _np(rv), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(float(tl), float(rl), rtol=1e-5)

    def test_transform_step(self, wsn_smoke):
        s = wsn_smoke
        r = r_prod.transform_step(jnp.asarray(s["V"]), jnp.asarray(s["mean"]),
                                  jnp.asarray(s["batch"]))
        t = prod.transform_step(torch.from_numpy(s["V"]),
                                torch.from_numpy(s["mean"]),
                                torch.from_numpy(s["batch"]))
        np.testing.assert_allclose(_np(t), _np(r), rtol=1e-5, atol=1e-4)

    def test_cov_update_step_emits_one_span(self, wsn_smoke):
        """``cov_update_step`` inside one span of its own, every operation
        of the step within it; ``transform_step`` opens none."""
        s = wsn_smoke
        st = cov.banded_init(s["p"], s["h"], device="cpu")
        x = torch.from_numpy(s["batch"])
        V, mean = torch.from_numpy(s["V"]), torch.from_numpy(s["mean"])
        _, events = _profiled(lambda: prod.cov_update_step(st, x))
        (sp,) = [e for e in events if e.name.startswith("repro_torch.")]
        assert sp.name == "repro_torch.production.fold"
        aten = [e for e in events if e.name.startswith("aten::")]
        assert aten and all(
            sp.time_range.start <= e.time_range.start
            and e.time_range.end <= sp.time_range.end for e in aten)
        _, events = _profiled(lambda: prod.transform_step(V, mean, x))
        assert not [e for e in events if e.name.startswith("repro_torch.")]


# --------------------------------------------------------------------------
_SIMULATOR = ("AggregationPrimitives", "NORM_PRIMITIVES",
              "TreeAggregationResult", "aggregate_tree",
              "LossyAggregationResult", "lossy_aggregate_tree",
              "tree_aggregate_fn")


def _definitions(path, pkg):
    """``{name: ast dump}`` of a module's top-level definitions, without
    docstrings, the package name read as ``repro``."""
    tree = ast.parse(path.read_text().replace(pkg, "repro"))
    out = {}
    for node in tree.body:
        for sub in ast.walk(node):
            body = getattr(sub, "body", None)
            if (isinstance(body, list) and body
                    and isinstance(body[0], ast.Expr)
                    and isinstance(body[0].value, ast.Constant)
                    and isinstance(body[0].value.value, str)):
                sub.body = body[1:] or [ast.Pass()]
        names = ([node.name] if hasattr(node, "name") else
                 [t.id for t in getattr(node, "targets", [])
                  if isinstance(t, ast.Name)])
        for n in names:
            out[n] = ast.dump(node)
    return out


class TestSimulator:
    @pytest.mark.parametrize("name", _SIMULATOR)
    def test_same_definition(self, name):
        """The tree simulator is the reference's code, definition for
        definition."""
        mine = _definitions(ROOT / "src/repro_torch/core/aggregation.py",
                            "repro_torch")
        theirs = _definitions(ROOT / "src/repro/core/aggregation.py",
                              "repro")
        assert mine[name] == theirs[name]

    @pytest.fixture(scope="class")
    def nets(self):
        pos = topo.berkeley_like_layout(52, seed=7)
        return (topo.build_topology(pos, 10.0),
                r_topo.build_topology(pos, 10.0))

    def test_topology_equal(self, nets):
        t, r = nets
        np.testing.assert_array_equal(t.adjacency, r.adjacency)
        np.testing.assert_array_equal(t.tree.parent, r.tree.parent)
        np.testing.assert_array_equal(topo.bandwidth_reduce(t.adjacency),
                                      r_topo.bandwidth_reduce(r.adjacency))

    def test_norm_and_pcag_packets(self, nets):
        t, r = nets
        rng = np.random.default_rng(8)
        vals = rng.normal(size=52)
        a = agg.aggregate_tree(t.tree, list(vals), agg.NORM_PRIMITIVES)
        b = r_agg.aggregate_tree(r.tree, list(vals), r_agg.NORM_PRIMITIVES)
        assert a.value == b.value
        np.testing.assert_array_equal(a.packets, b.packets)
        np.testing.assert_array_equal(a.record_sizes, b.record_sizes)
        W = rng.normal(size=(52, 4))
        za, pa = comp.scores_in_network(t.tree, W, vals)
        zb, pb = r_comp.scores_in_network(r.tree, W, vals)
        np.testing.assert_array_equal(za, zb)
        np.testing.assert_array_equal(pa, pb)

    @pytest.mark.parametrize("loss", [0.0, 0.3])
    def test_lossy_tree_same_draws(self, nets, loss):
        t, r = nets
        vals = list(np.random.default_rng(9).normal(size=52))
        a = agg.lossy_aggregate_tree(t.tree, vals, agg.NORM_PRIMITIVES,
                                     faults.FaultModel(link_loss=loss),
                                     np.random.default_rng(1))
        b = r_agg.lossy_aggregate_tree(r.tree, vals, r_agg.NORM_PRIMITIVES,
                                       r_faults.FaultModel(link_loss=loss),
                                       np.random.default_rng(1))
        for f in dataclasses.fields(a):
            np.testing.assert_array_equal(getattr(a, f.name),
                                          getattr(b, f.name))

    def test_surrogate_and_folds_equal(self):
        a = data.berkeley_surrogate(p=20, n_epochs=1500, seed=3)
        b = r_data.berkeley_surrogate(p=20, n_epochs=1500, seed=3)
        np.testing.assert_array_equal(a.measurements, b.measurements)
        for (ta, ea), (tb, eb) in zip(data.kfold_blocks(100, 7),
                                      r_data.kfold_blocks(100, 7)):
            np.testing.assert_array_equal(ta, tb)
            np.testing.assert_array_equal(ea, eb)

"""The PyTorch port's kernels against the JAX reference's kernels.

The port's wrappers (``repro_torch.kernels.ops``) take their plain PyTorch
versions on CPU tensors; here those are held against the reference's Pallas
kernels run in interpret mode on the same numpy inputs (``repro.kernels``
imports without touching ``jax.core``).  Shapes follow
tests/test_fused_stream.py: divisible, non-divisible, prime p, masked,
zero-weight tails.  The CUDA kernels themselves run only on a card:
tests/test_torch_cuda.py holds them against the plain versions there.

Tolerances: band and stage outputs rtol 1e-5, atol 1e-5 — the same fp32
products summed in another order.  In the bf16 tile mode both sides round
the same fp32 x and basis to bf16 (to nearest even) and then compute in
fp32, so the same tolerance holds there.  Flags are compared exactly
wherever the reconstruction error is more than 1e-4 from ε (a 1-ulp
difference in x̂ may flip a flag sitting on the boundary); in bf16 the
error is that of the bf16-rounded x, which the flag tests.
"""

import ast
import ctypes
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core.covariance import banded_matmul_ref as ref_banded_matmul
from repro.core.covariance import banded_matvec_ref as ref_banded_matvec
from repro.kernels import ops as ref_ops
from repro_torch.core.covariance import (band_to_dense, banded_matmul_ref,
                                         banded_matvec_ref)
from repro_torch.kernels import build, ops, ref

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-5, atol=1e-5)

# rows, p, q, masked, zero-weight tail (tests/test_fused_stream.py SHAPES)
SHAPES = [
    (32, 24, 4, False, False),
    (32, 24, 4, True, False),
    (15, 17, 3, False, False),
    (15, 17, 3, True, True),
    (8, 8, 2, False, True),
    (1, 8, 2, False, False),
    (40, 12, 3, True, False),
    (32, 64, 4, True, False),
    (32, 37, 4, True, True),
]


def _operands(rows, p, q, seed=0, masked=False, zero_tail=False):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(rows, p)).astype(np.float32)
    w = rng.uniform(0.2, 1.0, size=(rows,)).astype(np.float32)
    if zero_tail:
        w[-max(rows // 4, 1):] = 0.0
    basis = np.linalg.qr(rng.normal(size=(p, q)))[0].astype(np.float32)
    mean = rng.normal(size=(p,)).astype(np.float32)
    il = rng.uniform(0.5, 2.0, size=(q,)).astype(np.float32)
    mask = ((rng.random((rows, p)) > 0.2).astype(np.float32)
            if masked else None)
    return x, w, basis, mean, il, mask


def _close(a, b, **tol):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), **(tol or TOL))


def _flags_agree(fl_port, fl_ref, err, eps, margin=1e-4):
    fl_port, fl_ref = np.asarray(fl_port), np.asarray(fl_ref)
    clear = np.abs(np.asarray(err) - eps) > margin
    np.testing.assert_array_equal(fl_port[clear], fl_ref[clear])


def _port_fused(x, w, basis, mean, il, mask, h, eps, with_c, with_m,
                precision="fp32"):
    """The port's fused wrapper on a (rows, p) chunk written as K=rows
    rounds of n=1 epoch, so per-row weights and masks are per-round."""
    t = lambda a: None if a is None else torch.from_numpy(a)[None]
    return ops.fused_stream_update(
        t(x)[:, :, None, :], t(w), t(basis), t(mean), t(il), halfwidth=h,
        epsilon=eps, with_compress=with_c, with_monitor=with_m, mask=t(mask),
        precision=precision)


def _tile_x(x, precision):
    """The x the kernel's flag tests: fp32, or rounded to bf16."""
    if precision == "fp32":
        return x
    return torch.from_numpy(x).to(torch.bfloat16).float().numpy()


PRECISIONS = ["fp32", "bf16"]


class TestFusedPlainVsReference:
    @pytest.mark.parametrize("rows,p,q,masked,zt", SHAPES)
    @pytest.mark.parametrize("stages", ["cm", "c", "m"])
    @pytest.mark.parametrize("precision", PRECISIONS)
    def test_fused_matches_pallas(self, rows, p, q, masked, zt, stages,
                                  precision):
        h, eps = 3, 0.5
        x, w, basis, mean, il, mask = _operands(rows, p, q, masked=masked,
                                                zero_tail=zt)
        with_c, with_m = "c" in stages, "m" in stages
        r = ref_ops.fused_stream_update(
            x, w, basis, mean, il, halfwidth=h, epsilon=eps,
            with_compress=with_c, with_monitor=with_m, mask=mask,
            precision=precision, interpret=True)
        ops.reset_counts()
        o = _port_fused(x, w, basis, mean, il, mask, h, eps, with_c, with_m,
                        precision)
        kernel = "fused_stream_bf16" if precision == "bf16" \
            else "fused_stream"
        assert {k: v for k, v in ops.PLAIN_CALLS.items() if v} == {kernel: 1}
        _close(o[0][0], r[0])
        _close(o[1][0], r[1])
        if with_c:
            _close(o[2][0], r[2])
            err = np.abs(_tile_x(x, precision) - np.asarray(r[2]))
            _flags_agree(o[3][0], r[3], err, eps)
        else:
            assert o[2] is None and o[3] is None
        if with_m:
            _close(o[4][0], r[4])
            _close(o[5][0], r[5])
        else:
            assert o[4] is None and o[5] is None

    @pytest.mark.parametrize("p", [64, 37])
    def test_fleet_per_round_mask_matches_per_slot_reference(self, p):
        """A (S, K, n, p) fleet chunk with (S, K, p) liveness masks and
        per-round weights equals the reference per slot on its flattened
        (K*n, p) view with the mask and weights repeated per row."""
        S, K, n, q, h, eps = 3, 4, 8, 4, 3, 0.5
        rng = np.random.default_rng(p)
        x = rng.normal(size=(S, K, n, p)).astype(np.float32)
        w = rng.uniform(0.2, 1.0, size=(S, K)).astype(np.float32)
        w[1, -1] = 0.0
        masks = (rng.random((S, K, p)) > 0.2).astype(np.float32)
        basis = np.stack([np.linalg.qr(rng.normal(size=(p, q)))[0]
                          for _ in range(S)]).astype(np.float32)
        mean = rng.normal(size=(S, p)).astype(np.float32)
        il = rng.uniform(0.5, 2.0, size=(S, q)).astype(np.float32)
        T = torch.from_numpy
        o = ops.fused_stream_update(T(x), T(w), T(basis), T(mean), T(il),
                                    halfwidth=h, epsilon=eps,
                                    with_compress=True, with_monitor=True,
                                    mask=T(masks))
        for s in range(S):
            rows_mask = np.repeat(masks[s], n, axis=0)
            r = ref_ops.fused_stream_update(
                x[s].reshape(K * n, p), np.repeat(w[s], n), basis[s],
                mean[s], il[s], halfwidth=h, epsilon=eps, with_compress=True,
                with_monitor=True, mask=rows_mask, interpret=True)
            for i in (0, 1, 2, 4, 5):
                _close(o[i][s], r[i])
            err = np.abs(x[s].reshape(K * n, p) - np.asarray(r[2]))
            _flags_agree(o[3][s], r[3], err, eps)

    @pytest.mark.parametrize("precision", PRECISIONS)
    def test_stages_blocked_equals_fused_stages(self, precision):
        """The recompute gives the kernel's stage bits; in bf16 it takes
        the x the kernel took, already rounded, and rounds the basis by
        the same rule."""
        x, w, basis, mean, il, mask = _operands(32, 37, 4, masked=True)
        o = _port_fused(x, w, basis, mean, il, mask, 3, 0.5, True, True,
                        precision)
        t = lambda a: torch.from_numpy(a)[None]
        xt = t(x)[:, :, None, :]
        if precision == "bf16":
            xt = xt.to(torch.bfloat16)
        s = ops.fused_stream_stages_blocked(
            xt, t(basis), t(mean), t(il), epsilon=0.5,
            with_compress=True, with_monitor=True, mask=t(mask),
            precision=precision)
        for a, b in zip(s, o[1:]):
            torch.testing.assert_close(a, b, rtol=0, atol=0)

    @pytest.mark.parametrize("masked", [False, True])
    def test_bf16_tiles_round_the_operands(self, masked):
        """The bf16 tile mode is not the fp32 one: the band and the stage
        outputs move, by no more than the reference allows between the
        two modes (0.02 relative), and match the fp32 arithmetic on the
        bf16-rounded x and basis to the bit."""
        x, w, basis, mean, il, mask = _operands(32, 64, 4, masked=masked)
        args = (x, w, basis, mean, il, mask, 3, 0.5, True, True)
        f32, b16 = (_port_fused(*args, precision=pr) for pr in PRECISIONS)
        for i in (0, 1, 2, 4, 5):
            assert b16[i].dtype == torch.float32
            assert not torch.equal(b16[i], f32[i])
        for a, b in zip(f32[:3], b16[:3]):        # band, z, x_hat
            scale = float(a.abs().max()) + 1e-6
            assert float((a - b).abs().max()) / scale < 0.02
        rounded = lambda a: torch.from_numpy(a).to(torch.bfloat16).float()
        same = _port_fused(rounded(x).numpy(), w, rounded(basis).numpy(),
                           *args[3:])
        for a, b in zip(b16, same):
            if a is not None:
                torch.testing.assert_close(a, b, rtol=0, atol=0)

    def test_band_only_rejected(self):
        x, w, basis, mean, il, _ = _operands(8, 8, 2)
        with pytest.raises(ValueError, match="band-only"):
            _port_fused(x, w, basis, mean, il, None, 1, 0.5, False, False)


def _port_split_operands(x, basis, mean, il, mask):
    """A (rows, p) epoch batch as a fleet of one, mask per row."""
    t = lambda a: None if a is None else torch.from_numpy(a)[None]
    return t(x), t(basis), t(mean), t(il), t(mask)


class TestSplitStagesPlainVsReference:
    """Kernels 4, 5, 8 and 9 (plain versions) against the reference's
    Pallas kernels in interpret mode."""

    @pytest.mark.parametrize("rows,p,q,masked,zt", SHAPES)
    def test_supervised_compress_matches_pallas(self, rows, p, q, masked,
                                                zt):
        eps = 0.5
        x, _, basis, mean, _, mask = _operands(rows, p, q, masked=masked)
        r = ref_ops.supervised_compress(x, basis, mean, epsilon=eps,
                                        mask=mask, interpret=True)
        X, B, M, _, MK = _port_split_operands(x, basis, mean, None, mask)
        o = ops.supervised_compress(X, B, M, epsilon=eps, mask=MK)
        _close(o[0][0], r[0])
        _close(o[1][0], r[1])
        assert o[2].dtype == torch.bool
        _flags_agree(o[2][0], r[2], np.abs(x - np.asarray(r[1])), eps)

    @pytest.mark.parametrize("rows,p,q,masked,zt", SHAPES)
    def test_pca_monitor_matches_pallas(self, rows, p, q, masked, zt):
        x, _, basis, mean, il, mask = _operands(rows, p, q, masked=masked)
        r = ref_ops.pca_monitor(x, basis, mean, il, mask=mask,
                                interpret=True)
        X, B, M, IL, MK = _port_split_operands(x, basis, mean, il, mask)
        o = ops.pca_monitor(X, B, M, IL, mask=MK)
        for a, b in zip(o, r):
            _close(a[0], b)

    @pytest.mark.parametrize("rows,p,q,masked,zt", SHAPES)
    def test_project_and_reconstruct_match_pallas(self, rows, p, q, masked,
                                                  zt):
        x, _, basis, mean, _, mask = _operands(rows, p, q, masked=masked)
        xc = (x - mean) * (1.0 if mask is None else mask)
        z_r = ref_ops.pca_project(xc, basis, interpret=True)
        xh_r = ref_ops.pca_reconstruct(np.asarray(z_r), basis,
                                       interpret=True)
        X, B = torch.from_numpy(xc)[None], torch.from_numpy(basis)[None]
        z = ops.pca_project(X, B)
        _close(z[0], z_r)
        _close(ops.pca_reconstruct(torch.from_numpy(np.array(z_r))[None],
                                   B)[0], xh_r)

    @pytest.mark.parametrize("kernel", ["supervised_compress",
                                        "pca_monitor"])
    def test_plain_matches_reference_at_wide_p(self, kernel):
        """The plain versions against the reference at p = 7296, wider
        than the first CUDA design took (p + q <= 7264), a few masked
        rows.  The kernels there are held against these plain versions on
        the card (``tests/test_torch_cuda.py``, p = 8192)."""
        rows, p, q, eps = 6, 7296, 4, 0.5
        x, _, basis, mean, il, mask = _operands(rows, p, q, seed=3,
                                                masked=True)
        X, B, M, IL, MK = _port_split_operands(x, basis, mean, il, mask)
        if kernel == "supervised_compress":
            r = ref_ops.supervised_compress(x, basis, mean, epsilon=eps,
                                            mask=mask, interpret=True)
            o = ops.supervised_compress(X, B, M, epsilon=eps, mask=MK)
            _close(o[0][0], r[0])
            _close(o[1][0], r[1])
            _flags_agree(o[2][0], r[2], np.abs(x - np.asarray(r[1])), eps)
        else:
            r = ref_ops.pca_monitor(x, basis, mean, il, mask=mask,
                                    interpret=True)
            o = ops.pca_monitor(X, B, M, IL, mask=MK)
            for a, b in zip(o, r):
                _close(a[0], b)

    @pytest.mark.parametrize("p", [64, 37])
    def test_per_round_mask_matches_per_row_reference(self, p):
        """A (S, K, p) per-round mask read at row r // n equals the
        reference on each slot's rows with the mask repeated per row."""
        S, K, n, q, eps = 3, 4, 8, 4, 0.5
        rng = np.random.default_rng(p + 1)
        x = rng.normal(size=(S, K * n, p)).astype(np.float32)
        masks = (rng.random((S, K, p)) > 0.2).astype(np.float32)
        basis = np.stack([np.linalg.qr(rng.normal(size=(p, q)))[0]
                          for _ in range(S)]).astype(np.float32)
        mean = rng.normal(size=(S, p)).astype(np.float32)
        il = rng.uniform(0.5, 2.0, size=(S, q)).astype(np.float32)
        T = torch.from_numpy
        c = ops.supervised_compress(T(x), T(basis), T(mean), epsilon=eps,
                                    mask=T(masks), n=n)
        m = ops.pca_monitor(T(x), T(basis), T(mean), T(il), mask=T(masks),
                            n=n)
        for s in range(S):
            rows_mask = np.repeat(masks[s], n, axis=0)
            rc = ref_ops.supervised_compress(x[s], basis[s], mean[s],
                                             epsilon=eps, mask=rows_mask,
                                             interpret=True)
            rm = ref_ops.pca_monitor(x[s], basis[s], mean[s], il[s],
                                     mask=rows_mask, interpret=True)
            _close(c[0][s], rc[0])
            _close(c[1][s], rc[1])
            _flags_agree(c[2][s], rc[2], np.abs(x[s] - np.asarray(rc[1])),
                         eps)
            for a, b in zip(m, rm):
                _close(a[s], b)

    @pytest.mark.parametrize("kernel", ["supervised_compress", "pca_monitor",
                                        "pca_project", "pca_reconstruct"])
    def test_fleet_form_is_per_network_form(self, kernel):
        """The slot axis adds nothing: a fleet call equals one call per
        slot (rtol/atol 1e-5: batched products may sum in another order)."""
        S, K, n, p, q = 3, 2, 5, 37, 4
        rng = np.random.default_rng(5)
        T = lambda a: torch.from_numpy(a.astype(np.float32))
        x = T(rng.normal(size=(S, K * n, p)))
        basis = T(np.stack([np.linalg.qr(rng.normal(size=(p, q)))[0]
                            for _ in range(S)]))
        mean, il = T(rng.normal(size=(S, p))), T(rng.uniform(.5, 2, (S, q)))
        mk = T(rng.random((S, K, p)) > 0.2)
        call = {
            "supervised_compress": lambda sl: ops.supervised_compress(
                x[sl], basis[sl], mean[sl], epsilon=0.5, mask=mk[sl], n=n),
            "pca_monitor": lambda sl: ops.pca_monitor(
                x[sl], basis[sl], mean[sl], il[sl], mask=mk[sl], n=n),
            "pca_project": lambda sl: (ops.pca_project(x[sl], basis[sl]),),
            "pca_reconstruct": lambda sl: (ops.pca_reconstruct(
                x[sl][..., :q], basis[sl]),),
        }[kernel]
        fleet = call(slice(None))
        for s in range(S):
            for a, b in zip(fleet, call(slice(s, s + 1))):
                if a.dtype == torch.bool:
                    assert torch.equal(a[s], b[0])
                else:
                    torch.testing.assert_close(a[s], b[0], **TOL)

    def test_plain_path_counts_and_mask_shapes(self):
        ops.reset_counts()
        x, basis = torch.zeros((2, 8, 16)), torch.zeros((2, 16, 3))
        ops.supervised_compress(x, basis, epsilon=0.5,
                                mask=torch.ones((2, 4, 16)), n=2)
        ops.pca_monitor(x, basis, mask=torch.ones((2, 8, 16)))
        z = ops.pca_project(x, basis)
        ops.pca_reconstruct(z, basis)
        for k in ("supervised_compress", "pca_monitor", "pca_project",
                  "pca_reconstruct"):
            assert ops.PLAIN_CALLS[k] == 1, k
        assert sum(ops.LAUNCHES.values()) == 0
        with pytest.raises(ValueError, match="mask shape"):
            ops.pca_monitor(x, basis, mask=torch.ones((2, 4, 16)))
        with pytest.raises(ValueError, match="mask shape"):
            ops.pca_monitor(x, basis, mask=torch.ones((2, 4, 16)), n=3)


class TestBandFoldPlainVsReference:
    @pytest.mark.parametrize("K,n,p,h", [(4, 8, 64, 3), (4, 8, 37, 3),
                                         (3, 5, 17, 2), (1, 8, 24, 4),
                                         (2, 4, 8, 7)])
    @pytest.mark.parametrize("mask_kind", [None, "round", "reading"])
    def test_chunk_fold_matches_pallas(self, K, n, p, h, mask_kind):
        rng = np.random.default_rng(K * 100 + p)
        xs = rng.normal(size=(K, n, p)).astype(np.float32)
        w = rng.uniform(0.2, 1.0, size=(K,)).astype(np.float32)
        w[-1] = 0.0 if K > 1 else w[-1]
        mask = None
        if mask_kind == "round":
            mask = (rng.random((K, p)) > 0.2).astype(np.float32)
        elif mask_kind == "reading":
            mask = (rng.random((K, n, p)) > 0.2).astype(np.float32)
        r = ref_ops.cov_band_update_chunk(xs, w, h, mask=mask,
                                          interpret=True)
        T = torch.from_numpy
        o = ops.cov_band_update_chunk(T(xs), T(w), h,
                                      mask=None if mask is None else T(mask))
        _close(o, r)

    def test_fleet_form_is_per_network_form(self):
        rng = np.random.default_rng(1)
        xs = torch.from_numpy(rng.normal(size=(3, 4, 8, 37))
                              .astype(np.float32))
        w = torch.from_numpy(rng.uniform(0.2, 1.0, size=(3, 4))
                             .astype(np.float32))
        m = torch.from_numpy((rng.random((3, 4, 37)) > 0.2)
                             .astype(np.float32))
        out = ops.cov_band_update_chunk_batched(xs, w, 3, mask=m)
        for s in range(3):
            torch.testing.assert_close(
                out[s], ops.cov_band_update_chunk(xs[s], w[s], 3, mask=m[s]),
                **TOL)

    def test_plain_path_counts(self):
        ops.reset_counts()
        xs = torch.zeros((2, 4, 16))
        ops.cov_band_update_chunk(xs, torch.ones(2), 2)
        ops.cov_band_update_chunk(xs, torch.ones(2), 2,
                                  mask=torch.ones((2, 16)))
        assert ops.PLAIN_CALLS["band_fold"] == 1
        assert ops.PLAIN_CALLS["band_fold_masked"] == 1
        assert sum(ops.LAUNCHES.values()) == 0

    def test_bad_mask_shape_rejected(self):
        with pytest.raises(ValueError):
            ops.cov_band_update_chunk_batched(
                torch.zeros((1, 2, 4, 8)), torch.ones(2), 1,
                mask=torch.ones((1, 3, 8)))


class TestBandRoundPlainVsReference:
    """Kernels 6 and 7 (plain versions) against the reference's per-round
    Pallas kernels in interpret mode: prime p, n not a multiple of 8,
    h from 0 to past p."""

    @pytest.mark.parametrize("n,p,h", [(8, 64, 3), (6, 37, 3), (5, 17, 2),
                                       (13, 31, 0), (8, 24, 4), (4, 8, 7)])
    @pytest.mark.parametrize("mask_kind", [None, "live", "drop"])
    def test_round_fold_matches_pallas(self, n, p, h, mask_kind):
        rng = np.random.default_rng(n * 100 + p)
        x = rng.normal(size=(n, p)).astype(np.float32)
        mask = None
        if mask_kind == "live":
            mask = (rng.random((p,)) > 0.2).astype(np.float32)
        elif mask_kind == "drop":
            mask = (rng.random((n, p)) > 0.2).astype(np.float32)
        if mask is None:
            r = ref_ops.cov_band_update(x, h, interpret=True)
        else:
            r = ref_ops.cov_band_update_masked(x, mask, h, interpret=True)
        T = torch.from_numpy
        ops.reset_counts()
        o = ops.cov_band_update(T(x), h,
                                mask=None if mask is None else T(mask))
        kernel = {None: "band_round", "live": "band_round_masked",
                  "drop": "band_round_masked_drop"}[mask_kind]
        assert ops.PLAIN_CALLS[kernel] == 1
        _close(o, r)

    @pytest.mark.parametrize("mask_kind", [None, "live", "drop"])
    def test_round_is_one_round_chunk_bit_for_bit(self, mask_kind):
        """A round folds to the unit-weight one-round chunk's bits (the
        per-round and chunk plain paths share the fold)."""
        rng = np.random.default_rng(3)
        T = lambda a: torch.from_numpy(a.astype(np.float32))
        x = T(rng.normal(size=(3, 6, 37)))
        mask = {None: None, "live": T(rng.random((3, 37)) > 0.2),
                "drop": T(rng.random((3, 6, 37)) > 0.2)}[mask_kind]
        chunk_mask = None if mask is None else mask[:, None]
        a = ops.cov_band_update_batched(x, 3, mask=mask)
        b = ops.cov_band_update_chunk_batched(x[:, None], torch.ones(3, 1),
                                              3, mask=chunk_mask)
        assert torch.equal(a, b)

    def test_fleet_form_is_per_network_form(self):
        rng = np.random.default_rng(2)
        T = lambda a: torch.from_numpy(a.astype(np.float32))
        x, m = T(rng.normal(size=(3, 6, 37))), T(rng.random((3, 37)) > 0.2)
        out = ops.cov_band_update_batched(x, 3, mask=m)
        for s in range(3):
            torch.testing.assert_close(
                out[s], ops.cov_band_update(x[s], 3, mask=m[s]), **TOL)

    def test_bad_shapes_rejected(self):
        with pytest.raises(ValueError, match="mask shape"):
            ops.cov_band_update_batched(torch.zeros((2, 4, 8)), 1,
                                        mask=torch.ones((2, 3, 8)))
        with pytest.raises(ValueError, match="expected"):
            ops.cov_band_update(torch.zeros((2, 4, 8)), 1)


def _band_and_round(n, p, h, seed):
    """A non-symmetric (2h+1, p) band, every entry drawn (its out-of-range
    corners too), and an (n, p) round, on the CPU."""
    g = torch.Generator().manual_seed(seed)
    return (torch.randn((2 * h + 1, p), generator=g),
            torch.randn((n, p), generator=g))


class TestBandAccumulatePlain:
    """``ops.cov_band_accumulate`` (kernel 6 adding into a band) on the
    CPU: the two steps it replaces on the card, bit for bit."""

    @pytest.mark.parametrize("n,p,h", [(32, 64, 3), (6, 37, 3), (13, 31, 0),
                                       (65, 24, 30), (256, 52, 15)])
    def test_plain_path_is_band_plus_delta(self, n, p, h):
        band, x = _band_and_round(n, p, h, n + p + h)
        before = band.clone()
        ops.reset_counts()
        out = ops.cov_band_accumulate(band, x, h)
        assert {k: v for k, v in ops.PLAIN_CALLS.items() if v} == {
            "band_round": 1}
        assert sum(ops.LAUNCHES.values()) == 0
        assert ops.IN_KERNEL_ADDS == {"band_round": 0}
        assert torch.equal(out, band + ref.cov_band_update(x, h))
        assert torch.equal(band, before)      # a new band; the input kept
        assert out.data_ptr() != band.data_ptr()

    def test_banded_update_on_the_cpu_is_unchanged(self):
        """``banded_update`` off the card keeps the delta and the add."""
        from repro_torch.core import covariance as cov
        band, x = _band_and_round(20, 40, 5, 7)
        state = cov.BandedCovState(t=torch.tensor(3.0), s=torch.randn(40),
                                   band=band, halfwidth=5)
        ops.reset_counts()
        new = cov.banded_update(state, x)
        assert ops.PLAIN_CALLS["band_round"] == 1
        assert ops.IN_KERNEL_ADDS["band_round"] == 0
        assert torch.equal(new.band, band + ops.cov_band_update(x, 5))
        assert torch.equal(new.s, state.s + x.sum(0))
        assert float(new.t) == 23.0

    def test_fake_tensors_plan_the_band(self):
        """On fake tensors (the dry run) the call is planned, not run: an
        output of the band's shape and dtype, one PLANNED entry under
        ``band_round`` whose bytes the work model counts with the band
        read once more."""
        from torch._subclasses.fake_tensor import FakeTensorMode
        from repro_torch.analysis import op_lint, resources
        ops.reset_counts()
        with FakeTensorMode():
            band = torch.empty((9, 4096), device="cuda")
            out = ops.cov_band_accumulate(band, torch.empty((256, 4096),
                                                            device="cuda"), 4)
        assert out.shape == band.shape and out.dtype == torch.float32
        assert sum(ops.LAUNCHES.values()) + sum(
            ops.PLAIN_CALLS.values()) == 0
        (call,) = ops.PLANNED
        assert call[0] == "band_round" and call[2] == {"halfwidth": 4}
        assert call[1] == {"band": ((9, 4096), torch.float32),
                           "x": ((256, 4096), torch.float32)}
        d, model, got = resources.call_work(op_lint.KernelCall(*call))
        assert d["accumulate"] and model == got == 4 * (256 * 4096
                                                        + 2 * 9 * 4096)
        ops.reset_counts()

    @pytest.mark.parametrize("dtype,device,form", [
        (torch.float32, "cuda", "acc"), (torch.float64, "cuda", "delta"),
        (torch.float32, "cpu", "acc")])
    def test_banded_update_takes_the_acc_form_for_an_fp32_card_band(
            self, dtype, device, form, monkeypatch):
        """``banded_update`` hands an fp32 band to the accumulating form
        (on (fake) card tensors and on the CPU, where the wrapper takes its
        plain version), and keeps the delta and the add for an fp64 state:
        its choice rests on the band it is given."""
        from torch._subclasses.fake_tensor import FakeTensorMode
        from repro_torch.core import covariance as cov
        took = []
        monkeypatch.setattr(ops, "cov_band_accumulate", lambda b, x, h: (
            took.append("acc"), torch.empty_like(b))[1])
        monkeypatch.setattr(ops, "cov_band_update", lambda x, h: (
            took.append("delta"), x.new_empty((2 * h + 1, x.shape[1]),
                                              dtype=torch.float32))[1])
        with FakeTensorMode():
            on = dict(dtype=dtype, device=device)
            state = cov.BandedCovState(
                t=torch.zeros((), **on), s=torch.zeros((64,), **on),
                band=torch.zeros((7, 64), **on), halfwidth=3)
            new = cov.banded_update(state, torch.empty((32, 64),
                                                       device=device))
        assert took == [form]
        assert new.band.shape == (7, 64) and new.band.dtype == dtype

    def test_bad_shapes_rejected(self):
        band, x = _band_and_round(8, 16, 2, 0)
        with pytest.raises(ValueError, match="expected"):
            ops.cov_band_accumulate(band, x[None], 2)
        with pytest.raises(ValueError, match="band shape"):
            ops.cov_band_accumulate(band, x, 3)


def _header_constants(*names: str, files=("band_syrk.cuh", "band_fold.cu"),
                      ) -> dict[str, int]:
    """``constexpr int NAME = VALUE;`` of the band folds' headers (or of
    ``files`` in ``csrc/``; a product of two integers is evaluated)."""
    text = "".join((build.CSRC / f).read_text() for f in files)
    out = {}
    for name in names:
        m = re.search(rf"constexpr int {name} = (\d+)(?: \* (\d+))?;", text)
        assert m, name
        out[name] = int(m.group(1)) * int(m.group(2) or 1)
    return out


class TestBandRoundPlan:
    """``ops.band_round_plan``: the shape, segments, blocks and workspace
    of a kernel 6/7 launch, as ``csrc/band_fold.cu`` takes them.  The
    segments fix the order of sums, so they may depend on n alone."""

    @pytest.mark.parametrize("n", [1, 13, 32, 64, 65, 128, 129, 256, 1440])
    def test_segments_depend_on_n_only(self, n):
        plans = [ops.band_round_plan(S, n, p, h, sms)
                 for S, p, h, sms in [(1, 52, 15, 132), (256, 1024, 128, 132),
                                      (1, 1 << 20, 128, 132), (3, 37, 44, 8),
                                      (64, 52, 15, 132), (1, 52, 15, 1)]]
        assert {pl.segments for pl in plans} == {-(-n // ops.SEGMENT_ROWS)}

    @pytest.mark.parametrize("S,p,h", [(1, 52, 15), (256, 1024, 128),
                                       (1, 1 << 20, 128), (3, 37, 44)])
    @pytest.mark.parametrize("n", [1, 8, 32])
    def test_short_rounds_are_one_segment_without_workspace(self, S, n, p,
                                                            h):
        plan = ops.band_round_plan(S, n, p, h)
        assert (plan.segments, plan.shape, plan.workspace_bytes) == (
            1, "round", 0)

    @pytest.mark.parametrize("S", [1, 8, 64])
    def test_berkeley_fit_splits_its_segments_over_blocks(self, S):
        """The Berkeley fit's batch (n = 1,440, p = 52, h = 15: one tile)
        puts each of its 23 segments on a block of its own, with a
        workspace of the partial bands, also inside a small fleet."""
        plan = ops.band_round_plan(S, 1440, 52, 15)
        assert plan.shape == "split" and plan.segments == 23
        assert plan.blocks == 23
        assert ops.band_pairs(52, 15) == 712
        assert plan.workspace_bytes == 4 * S * 23 * 712

    @pytest.mark.parametrize("n", [65, 256, 1024])
    def test_wsn1m_batch_keeps_its_segments_in_one_block(self, n):
        """wsn-1m's production width fills the card with tiles: its
        segments stay in one block (kernel 2's tile at unit weight), no
        workspace (a segment's partials would be 1.08 GB)."""
        plan = ops.band_round_plan(1, n, 1 << 20, 128)
        assert plan.shape == "long" and plan.workspace_bytes == 0
        assert plan.blocks == (1 << 20) // 64 * 3

    @pytest.mark.parametrize("S,n,p,h", [(1, 70, 37, 44), (4, 129, 65, 0),
                                         (2, 257, 52, 15), (1, 300, 96, 6)])
    def test_split_only_below_the_card_and_for_small_bands(self, S, n, p,
                                                           h):
        """A small band (p <= SPLIT_MAX_P, a column a thread for each group
        of SPLIT_DIAGS diagonals) on a grid smaller than the card splits,
        one block a segment and a float a pair and segment; on a card of
        fewer SMs it does not, nor does a wider band."""
        small = ops.band_round_plan(S, n, p, h)
        assert small.shape == "split" and small.blocks == small.segments
        assert small.workspace_bytes == 4 * S * small.segments * \
            ops.band_pairs(p, h)
        assert p * -(-(min(h, p - 1) + 1) // ops.SPLIT_DIAGS) <= \
            ops.SPLIT_MAX_THREADS
        assert ops.band_round_plan(S, n, p, h, sms=1).shape == "long"
        assert ops.band_round_plan(S, n, 4 * p, 4 * h + 40).shape == "long"

    def test_header_constants_are_the_plan_constants(self):
        """L (``kSegRows``), the long-round threshold (``kLongRound``), the
        tile's columns and the split fold's limits, as the CUDA sources
        define them, are the plan's."""
        got = _header_constants("kSegRows", "kLongRound", "kSyrkT",
                                "kSyrkRows", "kRoundRows", "kPairThreads",
                                "kPairDiags", "kPairMaxP")
        assert got["kSegRows"] == ops.SEGMENT_ROWS
        assert got["kLongRound"] == ops.LONG_ROUND_ROWS
        assert got["kSyrkT"] == ops._TILE_COLS
        assert got["kPairThreads"] == ops.SPLIT_MAX_THREADS
        assert got["kPairDiags"] == ops.SPLIT_DIAGS
        assert got["kPairMaxP"] == ops.SPLIT_MAX_P
        # a serving round (32 rows) is one segment; segments end at stages
        assert ops.SEGMENT_ROWS >= 32
        for stage in ("kSyrkRows", "kRoundRows"):
            assert ops.SEGMENT_ROWS % got[stage] == 0, stage


class TestBandedMatvecPlan:
    """``ops.banded_matvec_plan``: the entry point and grid of a kernel-11
    launch (``csrc/banded.cu``) at the paths' widths."""

    @pytest.mark.parametrize("S,p,h,want", [
        # the Berkeley fit (31 diagonals of 52 and v: 6.5 KB)
        (1, 52, 15, ("slot", 64, 1, 4 * (31 * 52 + 52))),
        # the examples' fleets and engines at p = 32, h = 4
        (1, 32, 4, ("slot", 32, 1, 4 * (9 * 32 + 32))),
        (64, 32, 4, ("slot", 32, 1, 4 * (9 * 32 + 32))),
        # wsn-1m's production width and the sharded step's padded width
        (1, 1 << 20, 128, ("thread", 256, 4096, 0)),
        (1, (1 << 20) + 256, 128, ("thread", 256, 4097, 0)),
        # the refresh's band and the checker's engine widths
        (256, 1024, 128, ("thread", 256, 4, 0)),
        (8, 1024, 128, ("thread", 256, 4, 0)),
        # WSNConfig.smoke()'s one slot and the dry run's padded slice
        (1, 4096, 8, ("thread", 256, 16, 0)),
        (1, 4112, 8, ("thread", 256, 17, 0)),
        # a fleet of small bands as wide as the card: never timed as slots
        (256, 1024, 4, ("thread", 256, 4, 0)),
        (132, 32, 4, ("thread", 256, 1, 0))])
    def test_paths_widths(self, S, p, h, want):
        plan = ops.banded_matvec_plan(S, p, h)
        assert (plan.shape, plan.threads, plan.blocks,
                plan.smem_bytes) == want

    @pytest.mark.parametrize("p,h", [(52, 15), (52, 51), (1024, 4),
                                     (37, 128), (6133, 0), (400, 14),
                                     (1, 0), (1, 300)])
    def test_slot_up_to_its_shared_memory(self, p, h):
        """The slot shape where the in-range diagonals (at most 2p - 1)
        and v, 16-byte aligned, fit MATVEC_SLOT_MAX_BYTES; past it the
        first port's tile."""
        kd = min(2 * h + 1, 2 * p - 1)
        need = 4 * (-(-kd * p // 4) * 4 + p)
        assert ops._matvec_slot_bytes(p, h) == need
        plan = ops.banded_matvec_plan(1, p, h)
        fits = need <= ops.MATVEC_SLOT_MAX_BYTES
        assert plan.shape == ("slot" if fits else "thread")
        assert plan.smem_bytes == (need if fits else 0)

    def test_boundary_between_slot_and_thread(self):
        """p = 6,144 at h = 0 (one diagonal and v: 49,152 bytes, the
        limit) is the last slot, p = 6,145 the first port's tile; at 131
        slots of the card's 132 SMs a slot shape, at 132 the first port's
        tile."""
        assert ops.MATVEC_SLOT_MAX_BYTES == 49_152
        last = ops.banded_matvec_plan(32, 6144, 0)
        assert (last.shape, last.threads, last.smem_bytes) == \
            ("slot", 256, 49_152)
        assert ops.banded_matvec_plan(32, 6145, 0).shape == "thread"
        assert ops.banded_matvec_plan(131, 52, 15).shape == "slot"
        assert ops.banded_matvec_plan(132, 52, 15).shape == "thread"
        assert ops.banded_matvec_plan(3, 52, 15, sms=4).shape == "slot"
        assert ops.banded_matvec_plan(4, 52, 15, sms=4).shape == "thread"
        # the band grown until its rows of 400 overflow
        h = max(h for h in range(200)
                if ops.banded_matvec_plan(1, 400, h).shape == "slot")
        assert ops._matvec_slot_bytes(400, h) <= 49_152 \
            < ops._matvec_slot_bytes(400, h + 1)

    @pytest.mark.parametrize("p,threads", [(1, 32), (32, 32), (33, 64),
                                           (52, 64), (256, 256),
                                           (6144, 256)])
    def test_slot_block_covers_the_slot(self, p, threads):
        """A slot block has p rounded up to whole warps, at most
        MATVEC_SLOT_THREADS; its threads stride over p past that."""
        plan = ops.banded_matvec_plan(1, p, 0)
        assert (plan.shape, plan.threads, plan.blocks) == \
            ("slot", threads, 1)

    def test_header_constants_are_the_plan_constants(self):
        """The plan's constants as ``csrc/banded.cu`` defines them, and
        the entry point of each shape as ``build.SOURCES`` binds it."""
        got = _header_constants(
            "kBandedThreads", "kMatvecSlotThreads", "kMatvecSlotMaxBytes",
            files=("banded.cu",))
        assert got["kBandedThreads"] == ops.MATVEC_THREADS
        assert got["kMatvecSlotThreads"] == ops.MATVEC_SLOT_THREADS
        assert got["kMatvecSlotMaxBytes"] == ops.MATVEC_SLOT_MAX_BYTES
        entries = build.SOURCES["banded"]
        assert entries["banded_matvec_slot_f32"] == \
            entries["banded_matvec_f32"]


class TestBandedProduct:
    @pytest.mark.parametrize("p,h,q", [(64, 3, 4), (37, 3, 4), (16, 7, 2)])
    def test_dense_product_matches_reference_banded_matmul(self, p, h, q):
        """The dense (p, p) product, the port's ``banded_matmul_ref`` and
        the kernel's plain version against the reference's per-diagonal
        ``banded_matmul_ref`` (fp32; the dense product sums in another
        order)."""
        rng = np.random.default_rng(p)
        band = rng.normal(size=(2 * h + 1, p)).astype(np.float32)
        V = rng.normal(size=(p, q)).astype(np.float32)
        r = np.asarray(ref_banded_matmul(band, V))
        T = torch.from_numpy
        _close(band_to_dense(T(band)) @ T(V), r)
        _close(banded_matmul_ref(T(band), T(V)), r)
        _close(ref.banded_matmul(T(band), T(V)), r)

    @pytest.mark.parametrize("p", [64, 37])
    @pytest.mark.parametrize("h", [0, 1, 4])
    @pytest.mark.parametrize("q", [1, 3, 32])
    def test_banded_matmul_matches_pallas(self, p, h, q):
        """Kernel 10 (plain version) against the reference's Pallas
        kernel in interpret mode and its ``banded_matmul_ref``."""
        rng = np.random.default_rng(p * 10 + h + q)
        band = rng.normal(size=(2 * h + 1, p)).astype(np.float32)
        V = rng.normal(size=(p, q)).astype(np.float32)
        ops.reset_counts()
        o = ops.banded_matmul(torch.from_numpy(band), torch.from_numpy(V))
        assert ops.PLAIN_CALLS["banded_matmul"] == 1
        assert o.shape == (p, q)
        _close(o, ref_ops.banded_matmul(band, V, interpret=True))
        _close(o, ref_banded_matmul(band, V))

    @pytest.mark.parametrize("p", [64, 37])
    @pytest.mark.parametrize("h", [0, 1, 4])
    def test_banded_matvec_matches_pallas(self, p, h):
        """Kernel 11 (plain version) against the reference's Pallas
        kernel in interpret mode and its ``banded_matvec_ref``."""
        rng = np.random.default_rng(p + h)
        band = rng.normal(size=(2 * h + 1, p)).astype(np.float32)
        v = rng.normal(size=(p,)).astype(np.float32)
        ops.reset_counts()
        o = ops.banded_matvec(torch.from_numpy(band), torch.from_numpy(v))
        assert ops.PLAIN_CALLS["banded_matvec"] == 1
        _close(o, ref_ops.banded_matvec(band, v, interpret=True))
        _close(o, ref_banded_matvec(band, v))
        _close(banded_matvec_ref(torch.from_numpy(band),
                                 torch.from_numpy(v)), o)

    def test_fleet_form_is_per_network_form(self):
        """Leading axes flatten onto the fleet: each entry equals its own
        call, bit for bit (the same diagonals in the same order), and the
        matvec is the one-column matmul."""
        rng = np.random.default_rng(4)
        T = lambda a: torch.from_numpy(a.astype(np.float32))
        band, V = T(rng.normal(size=(2, 3, 9, 37))), T(
            rng.normal(size=(2, 3, 37, 5)))
        Y = ops.banded_matmul(band, V)
        y = ops.banded_matvec(band, V[..., 0])
        for a in range(2):
            for b in range(3):
                assert torch.equal(Y[a, b], ops.banded_matmul(band[a, b],
                                                              V[a, b]))
        assert torch.equal(y, ops.banded_matmul(band, V[..., :1])[..., 0])

    def test_bad_shapes_rejected(self):
        with pytest.raises(ValueError, match="do not fit"):
            ops.banded_matmul(torch.zeros((5, 8)), torch.zeros((7, 2)))
        with pytest.raises(ValueError, match="do not fit"):
            ops.banded_matmul(torch.zeros((4, 8)), torch.zeros((8, 2)))
        with pytest.raises(ValueError, match="do not fit"):
            ops.banded_matvec(torch.zeros((2, 5, 8)), torch.zeros((3, 8)))


class TestBuild:
    def test_sources_and_entry_points_declared(self):
        srcs = {p.stem for p in build.CSRC.glob("*.cu")}
        assert srcs == set(build.SOURCES)
        for name, fns in build.SOURCES.items():
            text = (build.CSRC / f"{name}.cu").read_text()
            for fn, argtypes in fns.items():
                m = re.search(rf"int {fn}\(([^)]*)\)", text)
                assert m, fn
                assert len(m.group(1).split(",")) == len(argtypes), fn
        # the q limits the wrappers query (stage_tile_max_q and the others)
        # name declared entries: on the CPU their branch never runs
        queried = re.findall(r'_max_q\("(\w+)", "(\w+)"',
                             (ROOT / "src/repro_torch/kernels/ops.py")
                             .read_text())
        assert ("pca_project", "stage_tile_max_q") in queried
        for lib, fn in queried:
            assert build.SOURCES[lib][fn] == [ctypes.c_int] * (
                2 if fn == "fused_stream_max_q" else 1), fn

    def test_targets_sm90a_into_ignored_build_dir(self):
        assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
        assert build.BUILD_DIR == ROOT / "build" / "repro_torch"
        assert "build/" in (ROOT / ".gitignore").read_text().split()


class TestNoJaxInPort:
    def test_port_and_chip_smoke_import_neither_jax_nor_repro(self):
        files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
        files += [ROOT / "chip_smoke.py", ROOT / "chip_ab.py"]
        bad = []
        for f in files:
            for node in ast.walk(ast.parse(f.read_text())):
                names = []
                if isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.module:
                    names = [node.module]
                for nm in names:
                    top = nm.split(".")[0]
                    if top in ("jax", "jaxlib", "repro"):
                        bad.append(f"{f.relative_to(ROOT)}: {nm}")
        assert not bad, bad


class TestChipAb:
    def test_parse_reads_rates_idle_shares_and_kernel_times(self):
        """``chip_ab.py`` reads both forms of chip_smoke.py's rate lines
        (with and without a step time), phase 10's bf16 engine lines (and
        skips its comparison line), the profiled idle share and the
        kernels' JSON record."""
        import importlib.util
        spec = importlib.util.spec_from_file_location("chip_ab",
                                                      ROOT / "chip_ab.py")
        chip_ab = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(chip_ab)
        log = "\n".join([
            "   stages engine: 6 steps, 7680 rounds in 1.50 s = 5120.0 "
            "rounds/s (163840 epochs/s), step 250.0 ms; refreshes 657",
            "   profile: device busy 0.9 s of 1.8 s wall (50.0%, idle "
            "50.0%)",
            "   band-only engine: 4 steps, 5120 rounds in 1.20 s = 4266.7 "
            "rounds/s (136533 epochs/s); refreshes 620",
            "   per-round fleet: 256 networks x 24 rounds in 0.48 s = "
            "12800.0 rounds/s, 20.0 ms a round; refreshes 668",
            "== 10 engine: fused stages, bf16 tiles",
            "   bf16 stages engine: 6 steps, 7680 rounds in 1.28 s = 6000.0 "
            "rounds/s (192000 epochs/s), step 213.3 ms; refreshes 657",
            "   bf16 vs fp32 (phase 4): 6000.0 vs 5120.0 rounds/s, step "
            "213.3 vs 250.0 ms",
            "   profiled bf16 stages engine: 6 steps, 7680 rounds in 1.50 s "
            "= 5120.0 rounds/s (163840 epochs/s), step 250.0 ms",
            "   profile: device busy 0.5 s of 1.5 s wall (33.3%, idle "
            "66.7%)",
            '{"kernels": [{"name": "banded_matmul", "ms": 0.5}]}',
            '{"ok": true}'])
        got = chip_ab.parse(log)
        assert got == pytest.approx({
            "stages engine: rounds/s": 5120.0,
            "stages engine: ms a step": 250.0,
            "stages engine: device idle %": 50.0,
            "band-only engine: rounds/s": 4266.7,
            "band-only engine: ms a step": 300.0,
            "per-round fleet: rounds/s": 12800.0,
            "per-round fleet: ms a round": 20.0,
            "bf16 stages engine: rounds/s": 6000.0,
            "bf16 stages engine: ms a step": 1280.0 / 6,
            "profiled bf16 stages engine: rounds/s": 5120.0,
            "profiled bf16 stages engine: ms a step": 250.0,
            "profiled bf16 stages engine: device idle %": 66.7,
            "kernel banded_matmul: ms": 0.5})

    def test_fold_table_holds_times_and_bits_by_side(self):
        """``--fold``'s table: each side's times in run order, and whether
        a call's bits held across all runs and across the change's."""
        import importlib.util
        spec = importlib.util.spec_from_file_location("chip_ab",
                                                      ROOT / "chip_ab.py")
        chip_ab = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(chip_ab)
        run = lambda ms, d6, dk: {
            "6": dict(ms=ms, device_ms=ms - 0.01, digest=d6),
            "6 Berkeley": dict(ms=ms / 4, device_ms=0.005, digest=dk)}
        table = chip_ab.fold_table([("base", run(0.2, "a", "b")),
                                    ("change", run(0.19, "a", "c")),
                                    ("change", run(0.18, "a", "c")),
                                    ("base", run(0.21, "a", "b"))])
        assert table["6"]["base ms"] == [0.2, 0.21]
        assert table["6"]["change device_ms"] == pytest.approx([0.18, 0.17])
        assert table["6"]["same bits"] is True
        assert table["6 Berkeley"]["same bits"] is False
        assert table["6 Berkeley"]["change repeats its bits"] is True

    def test_parse_reads_lm_serving_lines(self):
        """Phase 17's engine lines give tokens/s and the median decode
        step; its other lines (prefill, bound, checks) are not rates."""
        import importlib.util
        spec = importlib.util.spec_from_file_location("chip_ab",
                                                      ROOT / "chip_ab.py")
        chip_ab = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(chip_ab)
        log = "\n".join([
            "== 17 LM serving (dense and MoE) at full width",
            "   llama3.2-1b engine: 16 requests, 512 tokens in 1.250 s = "
            "409.6 tokens/s; decode step 12.50 ms (median of 60 steps at 8 "
            "live slots; min 12.10, max 13.00); 62 steps [NVIDIA H100 80GB "
            "HBM3, 700.00 W]",
            "   llama3.2-1b: prefill ms by bucket (prompt length rounded up "
            "to a power of two; the engine pads to it): 64: 20.00 x2",
            "   llama3.2-1b: decode step bound 0.976 ms (weights 2.997 GB + "
            "the fp32 KV cache 0.269 GB read once at 3.35 TB/s); measured "
            "/ bound 12.81x; peak memory 4.500 GB (max_memory_allocated "
            "less the 0.100 GB earlier phases hold)",
            "   granite-moe-3b-a800m engine: 16 requests, 512 tokens in "
            "3.000 s = 170.7 tokens/s; decode step 40.00 ms (median of 60 "
            "steps at 8 live slots; min 39.0, max 41.0); 62 steps",
            '{"ok": true}'])
        assert chip_ab.parse(log) == pytest.approx({
            "llama3.2-1b engine: tokens/s": 409.6,
            "llama3.2-1b engine: decode ms a step": 12.5,
            "granite-moe-3b-a800m engine: tokens/s": 170.7,
            "granite-moe-3b-a800m engine: decode ms a step": 40.0})

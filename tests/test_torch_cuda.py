"""The port's CUDA kernels against their plain PyTorch versions, on a card.

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Every test here carries the ``cuda`` marker and skips without a card (a
CUDA kernel has no CPU mode).  This file imports no JAX, so it runs on a
machine that has only PyTorch.  Tolerance rtol/atol 1e-5 at these small
widths (1e-4 at p=1024, where each score sums 1024 products): the same
fp32 products summed in another order; kernel 1's bf16 tile mode is held
to the same, against its plain version on the same bf16-rounded operands,
which it widens to fp32 as it loads them.  Flags are compared exactly
wherever the error is more than 1e-4 from ε.  The banded products
(kernels 10, 11) sum the diagonals in the plain version's order with the
plain version's roundings, so they are held to equal bits.  The chunk
folds (kernels 2, 3, 6, 7) are held to ``TOL`` against the plain version
up to 32 rows (1e-4 beyond: up to 256 products a pair, summed per round
in a chain, then weighted), and
to equal bits where their order of sums promises them: the mirrored half,
a second launch, kernel 1's band and, at K = 1, kernels 6 and 7.  Kernel
1's stage outputs are held bit for bit to the kernels whose order of sums
they keep (``TestCudaFusedTiles``).
"""

import dataclasses
import linecache
import warnings

import numpy as np
import pytest
import torch

from repro_torch.core.covariance import band_valid
from repro_torch.kernels import build, ops
from repro_torch.serve.engine import StreamingPCAEngine, StreamRequest
from repro_torch.kernels import ref
from repro_torch.streaming import (CompressionConfig, DetectionConfig,
                                   StreamConfig, batched_stream_init,
                                   batched_stream_run)
from repro_torch.streaming.driver import random_bases, tree_map

TOL = dict(rtol=1e-5, atol=1e-5)

# kernel 10's tiles, as banded_matmul_tile_f32 names them
_TILES = {"rows64": 1, "rows16": 2}


def _banded_tile(band, V, tile):
    """Kernel 10 through its C entry point with the tile named (the port
    always lets the kernel choose)."""
    S, nb, p = band.shape
    q = V.shape[-1]
    V = V.contiguous()
    Y = torch.empty((S, p, q), device=band.device)
    ret = build.load_library("banded").banded_matmul_tile_f32(
        band.data_ptr(), V.data_ptr(), S, p, (nb - 1) // 2, q, _TILES[tile],
        Y.data_ptr(), torch.cuda.current_stream().cuda_stream)
    assert ret == 0, f"cudaError {ret}"
    torch.cuda.synchronize()
    return Y


@pytest.mark.cuda
class TestCudaKernels:
    """The CUDA kernels against their plain versions, on the card
    (``python -m pytest -m cuda tests/test_torch_kernels.py``)."""

    @pytest.fixture(autouse=True)
    def _card(self):
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA card: the kernels have no CPU mode")

    @pytest.mark.parametrize("p,masked", [(64, False), (37, True),
                                          (1024, True)])
    def test_kernels_match_plain(self, p, masked):
        S, K, n, q, h = 3, 4, 8, 4, 3
        g = torch.Generator().manual_seed(p)
        x = torch.randn((S, K, n, p), generator=g)
        w = torch.rand((S, K), generator=g)
        m = (torch.rand((S, K, p), generator=g) > 0.2).float() \
            if masked else None
        basis = torch.linalg.qr(torch.randn((S, p, q), generator=g)).Q
        mean, il = torch.randn((S, p), generator=g), torch.ones((S, q))
        cpu = ops.fused_stream_update(x, w, basis, mean, il, halfwidth=h,
                                      epsilon=0.5, with_compress=True,
                                      with_monitor=True, mask=m)
        c = lambda t: None if t is None else t.cuda()
        ops.reset_counts()
        gpu = ops.fused_stream_update(c(x), c(w), c(basis), c(mean), c(il),
                                      halfwidth=h, epsilon=0.5,
                                      with_compress=True, with_monitor=True,
                                      mask=c(m))
        band = ops.cov_band_update_chunk_batched(c(x), c(w), h, mask=c(m))
        torch.cuda.synchronize()
        assert ops.LAUNCHES["fused_stream"] == 1
        for i in (0, 1, 2, 4, 5):
            torch.testing.assert_close(gpu[i].cpu(), cpu[i], **TOL)
        # flags: bool, exact wherever the error is more than 1e-4 from eps
        assert gpu[3].dtype == cpu[3].dtype == torch.bool
        err = (x.reshape(S, K * n, p) - cpu[2]).abs()
        clear = (err - 0.5).abs() > 1e-4
        assert torch.equal(gpu[3].cpu()[clear], cpu[3][clear])
        torch.testing.assert_close(band.cpu(), cpu[0], **TOL)

    @pytest.mark.parametrize("p", [17, 37, 64])
    @pytest.mark.parametrize("masked", [False, True])
    def test_bf16_tiles_match_plain(self, p, masked):
        """Kernel 1 in its bf16 tile mode (``fused_stream_bf16``) against
        the plain version on the same bf16-rounded x and basis; the card
        rounds fp32 to bf16 as the CPU does (to nearest even)."""
        S, K, n, q, h, eps = 3, 4, 8, 4, 3, 0.5
        g = torch.Generator().manual_seed(p + masked)
        x = torch.randn((S, K, n, p), generator=g)
        w = torch.rand((S, K), generator=g)
        m = (torch.rand((S, K, p), generator=g) > 0.2).float() \
            if masked else None
        basis = torch.linalg.qr(torch.randn((S, p, q), generator=g)).Q
        mean, il = torch.randn((S, p), generator=g), torch.ones((S, q))
        assert torch.equal(x.cuda().to(torch.bfloat16).cpu(),
                           x.to(torch.bfloat16))
        kw = dict(halfwidth=h, epsilon=eps, with_compress=True,
                  with_monitor=True, precision="bf16")
        cpu = ops.fused_stream_update(x, w, basis, mean, il, mask=m, **kw)
        c = lambda t: None if t is None else t.cuda()
        ops.reset_counts()
        gpu = ops.fused_stream_update(c(x), c(w), c(basis), c(mean), c(il),
                                      mask=c(m), **kw)
        torch.cuda.synchronize()
        assert ops.LAUNCHES["fused_stream_bf16"] == 1
        assert ops.LAUNCHES["fused_stream"] == 0
        assert sum(ops.PLAIN_CALLS.values()) == 0
        for i in (0, 1, 2, 4, 5):
            assert gpu[i].dtype == torch.float32
            torch.testing.assert_close(gpu[i].cpu(), cpu[i], **TOL)
        xb = x.to(torch.bfloat16).float().reshape(S, K * n, p)
        clear = ((xb - cpu[2]).abs() - eps).abs() > 1e-4
        assert torch.equal(gpu[3].cpu()[clear], cpu[3][clear])


def _fold_operands(S, K, n, p, mask_kind, seed):
    """A chunk fold's card operands: x (S, K, n, p); weights (S, K) with a
    padded last round (weight 0) and, at S = 3, a slot of zero weights;
    no mask, a (S, K, p) liveness or a (S, K, n, p) dropout mask."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((S, K, n, p), generator=g)
    w = torch.rand((S, K), generator=g) + 0.25
    if K > 1:
        w[:, -1] = 0.0
    if S > 1:
        w[1] = 0.0
    m = {None: None,
         "live": (torch.rand((S, K, p), generator=g) > 0.2).float(),
         "drop": (torch.rand((S, K, n, p), generator=g) > 0.2).float(),
         }[mask_kind]
    return x.cuda(), w.cuda(), None if m is None else m.cuda()


def _assert_mirrored(band, h):
    """The band is exactly symmetric, band[h - d, i + d] == band[h + d, i],
    and exactly 0 where i + k - h falls outside [0, p)."""
    p = band.shape[-1]
    for d in range(1, min(h, p - 1) + 1):
        assert torch.equal(band[:, h - d, d:], band[:, h + d, :p - d]), d
    outside = 1.0 - band_valid(p, h, device=band.device)
    assert torch.equal(band * outside, torch.zeros_like(band))


def _halfwidth(h, p):
    return {"p-1": p - 1, "p+7": p + 7}.get(h, h)


@pytest.mark.cuda
class TestCudaChunkFold:
    """Kernels 2 and 3 (the banded SYRK of ``csrc/band_syrk.cuh``: 64 x 64
    tiles of the upper band, mirrored) against the plain version on the
    same card tensors (``TOL`` up to 32 rows, 1e-4 beyond: the module
    docstring), with the bits the design promises: an
    exactly symmetric band with exact zeros outside it, equal bits from
    two launches, and kernel 1's band (fp32 and bf16 tiles) equal to
    theirs.  The K = 1 equal-bits checks against kernels 6 and 7 are
    ``TestCudaRoundAndBandedKernels.test_round_fold_matches_plain``."""

    @pytest.fixture(autouse=True)
    def _card(self):
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA card: the kernels have no CPU mode")

    def _fold(self, x, w, h, m):
        ops.reset_counts()
        band = ops.cov_band_update_chunk_batched(x, w, h, mask=m)
        again = ops.cov_band_update_chunk_batched(x, w, h, mask=m)
        torch.cuda.synchronize()
        kernel = "band_fold" if m is None else "band_fold_masked"
        assert ops.LAUNCHES[kernel] == 2
        assert sum(ops.PLAIN_CALLS.values()) == 0
        assert torch.equal(band, again)
        _assert_mirrored(band, h)
        # each round's products in a chain, then the weighted rounds; the
        # plain version sums in a tree.  Over 250 rows the chain's rounding
        # reaches ~2e-5 on pairs that cancel to near 0 (1.2e-5 seen at
        # p=130, 10 x 25 rows), so the longer chunks are held to 1e-4, as
        # a 1024-product score is above.
        tol = TOL if x.shape[1] * x.shape[2] <= 32 \
            else dict(rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(band, ref.band_fold(x, w, h, m), **tol)
        return band

    @pytest.mark.parametrize("mask_kind", [None, "live", "drop"])
    @pytest.mark.parametrize("K,n", [(1, 13), (4, 8), (10, 25), (8, 32)])
    @pytest.mark.parametrize("h", [0, 3, 63, 64, 128, "p-1", "p+7"])
    @pytest.mark.parametrize("p", [17, 37, 63, 64, 65, 130, 1021, 1024])
    def test_chunk_fold_matches_plain(self, p, h, K, n, mask_kind):
        """Three slots (one of zero weights, the others with a padded
        round); p below, at and across the 64-column tile, odd p (4-byte
        copies); h from 0 past both ends of the band; rounds that straddle
        the 16-row stages (n = 13, 25) and that fill them (n = 8, 32)."""
        h = _halfwidth(h, p)
        x, w, m = _fold_operands(3, K, n, p, mask_kind, p * 131 + h * 7 + K)
        self._fold(x, w, h, m)

    @pytest.mark.parametrize("mask_kind", [None, "live", "drop"])
    @pytest.mark.parametrize("p", [17, 65, 1021, 1024])
    def test_chunk_fold_one_slot(self, p, mask_kind):
        """A fleet of one slot at the slice's halfwidth and ten rounds of
        25 epochs."""
        x, w, m = _fold_operands(1, 10, 25, p, mask_kind, p)
        self._fold(x, w, 128, m)

    @pytest.mark.parametrize("precision", ["fp32", "bf16"])
    @pytest.mark.parametrize("masked", [False, True])
    @pytest.mark.parametrize("p,h", [(17, 3), (37, 36), (64, 63), (130, 64),
                                     (1021, 128), (1024, 128)])
    def test_fused_band_equals_chunk_fold(self, p, h, masked, precision):
        """Kernel 1's fold blocks are kernel 2's or 3's tile: its band
        equals theirs bit for bit on the same operands — in the bf16 tile
        mode on the bf16-rounded x, which kernel 1 stages as it lies and
        widens exactly."""
        S, K, n, q = 3, 10, 25, 4
        x, w, m = _fold_operands(S, K, n, p, "live" if masked else None, p)
        g = torch.Generator().manual_seed(p + 1)
        basis = torch.linalg.qr(torch.randn((S, p, q), generator=g)).Q.cuda()
        out = ops.fused_stream_update(x, w, basis, halfwidth=h, epsilon=0.5,
                                      with_compress=True, with_monitor=True,
                                      mask=m, precision=precision)
        xt = ops.fused_tiles(x, precision).float()
        band = ops.cov_band_update_chunk_batched(xt, w, h, mask=m)
        torch.cuda.synchronize()
        assert torch.equal(out[0], band)


def _fused_operands(S, K, n, p, q, masked, seed):
    """Kernel 1's card operands: x (S, K, n, p); weights (S, K) with a
    padded last round; a (S, K, p) liveness mask or None; a row-major
    (S, p, q) basis (orthonormal where q <= p); mean (S, p); inv_lam
    (S, q)."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((S, K, n, p), generator=g)
    w = torch.rand((S, K), generator=g) + 0.25
    w[:, -1] = 0.0
    m = (torch.rand((S, K, p), generator=g) > 0.2).float() if masked \
        else None
    basis = torch.randn((S, p, q), generator=g)
    if q <= p:
        basis = torch.linalg.qr(basis).Q
    mean = 0.1 * torch.randn((S, p), generator=g)
    il = torch.rand((S, q), generator=g) + 0.5
    c = lambda t: None if t is None else t.contiguous().cuda()
    return c(x), c(w), c(m), c(basis), c(mean), c(il)


@pytest.mark.cuda
class TestCudaFusedTiles:
    """Kernel 1 (``fused_stream_f32`` and ``fused_stream_bf16``) at the
    edges of its tiles: the fold is kernel 3's (2's) banded SYRK tile, the
    stages the register tile of ``csrc/stage_tile.cuh`` (64 rows a block,
    p streamed in 32- and 64-sensor slices, q in 32-column passes).
    Against the plain version on the same card tensors (``TOL`` at p <= 64,
    1e-4 beyond, and 1e-4 for the band of 10 x 25 rows, as the chunk
    folds), and bit for bit against the kernels whose order of sums each
    output keeps: the band kernel 3's (2's), z kernel 8's on the centred,
    masked rows formed in torch, x̂ kernel 9's on that z plus the mean, T²
    and SPE kernel 5's and the flags kernel 4's (the stage arithmetic of
    kernel 1 before its tile), in both tile modes (kernels 2-9 take the
    bf16-rounded operands widened).  One launch, no plain call, equal
    bits on a second launch."""

    @pytest.fixture(autouse=True)
    def _card(self):
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA card: the kernels have no CPU mode")

    def _check(self, S, K, n, p, q, h, masked, stages, precision):
        x, w, m, basis, mean, il = _fused_operands(
            S, K, n, p, q, masked, p * 7 + q * 3 + h + S + K)
        wc, wm, eps = "c" in stages, "m" in stages, 0.5
        kernel = "fused_stream_bf16" if precision == "bf16" \
            else "fused_stream"
        run = lambda: ops.fused_stream_update(
            x, w, basis, mean, il, halfwidth=h, epsilon=eps,
            with_compress=wc, with_monitor=wm, mask=m, precision=precision)
        ops.reset_counts()
        out = run()
        torch.cuda.synchronize()
        assert ops.LAUNCHES[kernel] == 1 and sum(ops.LAUNCHES.values()) == 1
        assert sum(ops.PLAIN_CALLS.values()) == 0
        again = run()
        assert all(a is None and b is None or torch.equal(a, b)
                   for a, b in zip(out, again))
        band, z, xh, fl, t2, spe = out
        assert (xh is None, fl is None) == (not wc, not wc)
        assert (t2 is None, spe is None) == (not wm, not wm)
        # the plain version and the yardsticks on the widened tile operands
        xt = ops.fused_tiles(x, precision).float()
        bt = ops.fused_tiles(basis, precision).float().contiguous()
        plain = ref.fused_stream(xt, w, bt, mean, il, h, eps, m)
        tol = TOL if p <= 64 else dict(rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(band, plain[0], rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(z, plain[1], **tol)
        assert torch.equal(band, ops.cov_band_update_chunk_batched(
            xt, w, h, mask=m))
        R = K * n
        xv = xt.reshape(S, R, p)
        xc = xv - mean[:, None, :]
        if m is not None:
            xc = xc * m.repeat_interleave(n, dim=1)
        z8 = ops.pca_project(xc.contiguous(), bt)
        assert torch.equal(z, z8)
        if wc:
            torch.testing.assert_close(xh, plain[2], **tol)
            assert torch.equal(xh, ops.pca_reconstruct(z8, bt)
                               + mean[:, None, :])
            clear = ((xv - plain[2]).abs() - eps).abs() > 1e-4
            assert fl.dtype == torch.bool
            assert torch.equal(fl[clear], plain[3][clear])
            _, _, fl4 = ops.supervised_compress(xv.contiguous(), bt, mean,
                                                epsilon=eps, mask=m, n=n)
            assert torch.equal(fl, fl4)
        if wm:
            torch.testing.assert_close(t2, plain[4], **tol)
            torch.testing.assert_close(spe, plain[5], **tol)
            _, t25, spe5 = ops.pca_monitor(xv.contiguous(), bt, mean, il,
                                           mask=m, n=n)
            assert torch.equal(t2, t25)
            assert torch.equal(spe, spe5)

    @pytest.mark.parametrize("precision", ["fp32", "bf16"])
    @pytest.mark.parametrize("masked", [False, True])
    @pytest.mark.parametrize("h", [0, 64, "p+7"])
    @pytest.mark.parametrize("p,q", [(p, q) for p in (17, 37, 64, 1021, 1024)
                                     for q in (1, 4, 7, 32) if q <= p])
    def test_fused_tiles_match_plain(self, p, q, h, masked, precision):
        """Three slots of 10 rounds x 25 epochs (250 rows: four stage
        blocks, the last one ragged); odd p (plain loads in the bf16 mode,
        single values in fp32) and p at and across the 64-sensor tiles; q
        below, at and not a multiple of the 16-byte copies; h from 0 past
        both ends of the band."""
        self._check(3, 10, 25, p, q, _halfwidth(h, p), masked, "cm",
                    precision)

    @pytest.mark.parametrize("precision", ["fp32", "bf16"])
    @pytest.mark.parametrize("S", [1, 3])
    @pytest.mark.parametrize("masked", [False, True])
    @pytest.mark.parametrize("stages", ["cm", "c", "m"])
    @pytest.mark.parametrize("p,q", [(37, 7), (1024, 32), (136, 40)])
    def test_fused_stages_and_slots(self, p, q, stages, masked, S,
                                    precision):
        """Compression only, monitoring only and both, one slot and three,
        at the slice's width and h, and q = 40 (two passes of phase A)."""
        self._check(S, 8, 32, p, q, 128, masked, stages, precision)

    @pytest.mark.parametrize("precision", ["fp32", "bf16"])
    def test_fused_q_limit(self, precision):
        """q up to the stage tile's shared memory (``fused_stream_max_q``,
        at least the slice's 32); one more raises a ``ValueError``."""
        lib = build.load_library("fused_stream")
        max_q = lib.fused_stream_max_q(torch.cuda.current_device(),
                                       int(precision == "bf16"))
        assert max_q >= 32
        x, w, m, basis, mean, il = _fused_operands(1, 2, 4, 16, max_q + 1,
                                                   True, max_q)
        with pytest.raises(ValueError, match=rf"q={max_q + 1} exceeds "
                           rf"kernel 1's shared memory \(q <= {max_q}"):
            ops.fused_stream_update(x, w, basis, mean, il, halfwidth=3,
                                    with_compress=True, with_monitor=True,
                                    mask=m, precision=precision)
        basis, il = basis[..., :max_q].contiguous(), il[:, :max_q]
        out = ops.fused_stream_update(x, w, basis, mean, il, halfwidth=3,
                                      epsilon=0.5, with_compress=True,
                                      with_monitor=True, mask=m,
                                      precision=precision)
        xt = ops.fused_tiles(x, precision).float()
        bt = ops.fused_tiles(basis, precision).float()
        plain = ref.fused_stream(xt, w, bt, mean, il, 3, 0.5, m)
        for i in (0, 1, 2, 4, 5):
            torch.testing.assert_close(out[i], plain[i], rtol=1e-4,
                                       atol=1e-4)


def _split_operands(S, R, p, q, masked, n):
    g = torch.Generator().manual_seed(p + S)
    x = torch.randn((S, R, p), generator=g)
    basis = torch.linalg.qr(torch.randn((S, p, q), generator=g)).Q
    mean = 0.1 * torch.randn((S, p), generator=g)
    il = torch.rand((S, q), generator=g) + 0.5
    m = ((torch.rand((S, R // n, p), generator=g) > 0.2).float()
         if masked else None)
    return x, basis, mean, il, m


def _stage_operands(S, R, n, p, q, mask_kind, seed):
    """Kernels 4 and 5's card operands: x (S, R, p); a row-major (S, p, q)
    basis (orthonormal where q <= p); mean (S, p); inv_lam (S, q); and a
    mask per row (S, R, p), per round (S, R / n, p), or None."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((S, R, p), generator=g)
    basis = torch.randn((S, p, q), generator=g)
    if q <= p:
        basis = torch.linalg.qr(basis).Q
    mean = 0.1 * torch.randn((S, p), generator=g)
    il = torch.rand((S, q), generator=g) + 0.5
    rows = {"row": R, "round": R // n, None: 0}[mask_kind]
    m = ((torch.rand((S, rows, p), generator=g) > 0.2).float()
         if mask_kind else None)
    c = lambda t: None if t is None else t.contiguous().cuda()
    return c(x), c(basis), c(mean), c(il), c(m)


@pytest.mark.cuda
class TestCudaSplitKernels:
    """Kernels 4, 5, 8 and 9 against their plain versions, on the card.
    Kernels 4 and 5 are kernel 1's stage tile (``csrc/stage_tile.cuh``,
    64 rows a block, or 32 for a round of at most 32 rows; p in 32- and
    64-sensor slices, q in 32-column passes), held at its edges to ``TOL``
    (1e-4 past p = 64) and bit for bit to the kernels whose order of sums
    each output keeps."""

    @pytest.fixture(autouse=True)
    def _card(self):
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA card: the kernels have no CPU mode")

    @pytest.mark.parametrize("mask_kind", [None, "row", "round"])
    @pytest.mark.parametrize("q", [1, 4, 32])
    @pytest.mark.parametrize("S,R,n", [(3, 29, 29), (2, 100, 25),
                                       (3, 32, 32)])
    @pytest.mark.parametrize("p", [37, 64, 1024, 8192])
    def test_stage_kernels_at_tile_edges(self, p, S, R, n, q, mask_kind):
        """Ragged row blocks (29, 100 rows), the per-round fleet's round (32
        rows with a (S, 1, p) liveness row, n = 32), p odd, at one tile and
        past the first design's p + q <= 7264 (8192), q below and at the
        16-byte copies and at one column pass; 64-row blocks, or 32 at the
        round.  Against the plain version: ``TOL``, flags exact away from
        eps.  Bit for bit: z == kernel 8's on (x - mean) m formed in torch
        (kernels 4 and 5), kernel 4's x_hat == kernel 9's on that z plus
        the mean, a repeat launch, a per-round mask == its per-row
        expansion, and, with a per-round mask or none, the flags, T2 and
        SPE == kernel 1's on the same rows as a chunk of R / n rounds.
        Through the wrappers: one launch each, no plain call."""
        eps = 0.5
        x, basis, mean, il, m = _stage_operands(
            S, R, n, p, q, mask_kind, p * 7 + R + q * 3 + S)
        div = n if mask_kind == "round" else None

        def comp(mk=m, d=div):
            return ops.supervised_compress(x, basis, mean, epsilon=eps,
                                           mask=mk, n=d)

        def mon(mk=m, d=div):
            return ops.pca_monitor(x, basis, mean, il, mask=mk, n=d)

        ops.reset_counts()
        z4, xh, fl = comp()
        z5, t2, spe = mon()
        torch.cuda.synchronize()
        assert ops.LAUNCHES["supervised_compress"] == 1
        assert ops.LAUNCHES["pca_monitor"] == 1
        assert sum(ops.LAUNCHES.values()) == 2
        assert sum(ops.PLAIN_CALLS.values()) == 0
        rows_m = None if m is None else (
            m.repeat_interleave(n, dim=1) if div else m)
        tol = TOL if p <= 64 else dict(rtol=1e-4, atol=1e-4)
        pz, pxh, pfl = ref.supervised_compress(x, basis, mean, rows_m, eps)
        mz, pt2, pspe = ref.pca_monitor(x, basis, mean, il, rows_m)
        for got, want in ((z4, pz), (xh, pxh), (z5, mz), (t2, pt2),
                          (spe, pspe)):
            torch.testing.assert_close(got, want, **tol)
        assert fl.dtype == torch.bool
        clear = ((x - pxh).abs() - eps).abs() > 1e-4
        assert torch.equal(fl[clear], pfl[clear])
        xc = x - mean[:, None, :]
        if rows_m is not None:
            xc = xc * rows_m
        z8 = ops.pca_project(xc.contiguous(), basis)
        assert torch.equal(z4, z8) and torch.equal(z5, z8)
        assert torch.equal(xh, ops.pca_reconstruct(z8, basis)
                           + mean[:, None, :])
        for a, b in zip((z4, xh, fl, z5, t2, spe), comp() + mon()):
            assert torch.equal(a, b)
        if div:
            for a, b in zip((z4, xh, fl, z5, t2, spe),
                            comp(rows_m, None) + mon(rows_m, None)):
                assert torch.equal(a, b)
        if mask_kind != "row":
            K = R // n
            out = ops.fused_stream_update(
                x.reshape(S, K, n, p), torch.ones((S, K), device="cuda"),
                basis, mean, il, halfwidth=3, epsilon=eps,
                with_compress=True, with_monitor=True, mask=m)
            assert torch.equal(out[3], fl)
            assert torch.equal(out[4], t2) and torch.equal(out[5], spe)

    @pytest.mark.parametrize("kernel", ["supervised_compress",
                                        "pca_monitor"])
    def test_stage_q_limit(self, kernel):
        """Kernels 4 and 5 take q up to the stage tile's shared memory
        (``stage_tile_max_q``, at least the slice's 32, at any p); one more
        raises a ``ValueError``, never a wrong result."""
        lib = build.load_library("pca_project")
        max_q = lib.stage_tile_max_q(torch.cuda.current_device())
        assert max_q >= 32
        x, basis, mean, il, m = _stage_operands(2, 40, 8, 16, max_q + 1,
                                                "round", max_q)
        call = {
            "supervised_compress": lambda b: ops.supervised_compress(
                x, b, mean, epsilon=0.5, mask=m, n=8),
            "pca_monitor": lambda b: ops.pca_monitor(
                x, b, mean, il[:, :b.shape[-1]].contiguous(), mask=m, n=8),
        }[kernel]
        with pytest.raises(ValueError, match=rf"q={max_q + 1} exceeds the "
                           rf"stage tile's shared memory \(q <= {max_q}\)"):
            call(basis)
        basis = basis[..., :max_q].contiguous()
        out = call(basis)
        rows_m = m.repeat_interleave(8, dim=1)
        plain = (ref.supervised_compress(x, basis, mean, rows_m, 0.5)
                 if kernel == "supervised_compress" else
                 ref.pca_monitor(x, basis, mean, il[:, :max_q], rows_m))
        for got, want in zip(out, plain):
            if got.dtype != torch.bool:
                torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)

    @pytest.mark.parametrize("p,masked", [(64, False), (37, True),
                                          (1024, True), (8192, True)])
    def test_split_kernels_match_plain(self, p, masked):
        S, K, n, q, eps = 3, 4, 8, 4, 0.5
        R = K * n - 3                        # a ragged last row block
        x, basis, mean, il, m = _split_operands(S, K * n, p, q, masked, n)
        x = x[:, :R].contiguous()
        if m is not None:                    # per-row form for ragged R
            m = m.repeat_interleave(n, dim=1)[:, :R].contiguous()
        tol = dict(rtol=1e-4, atol=1e-4) if p >= 1024 else TOL
        c = lambda t: None if t is None else t.cuda()
        ops.reset_counts()
        pairs = [
            (ops.supervised_compress(x, basis, mean, epsilon=eps, mask=m),
             ops.supervised_compress(c(x), c(basis), c(mean), epsilon=eps,
                                     mask=c(m))),
            (ops.pca_monitor(x, basis, mean, il, mask=m),
             ops.pca_monitor(c(x), c(basis), c(mean), c(il), mask=c(m))),
            ((ops.pca_project(x, basis),), (ops.pca_project(c(x),
                                                            c(basis)),)),
            ((ops.pca_reconstruct(x[..., :q], basis),),
             (ops.pca_reconstruct(c(x[..., :q].contiguous()), c(basis)),)),
        ]
        torch.cuda.synchronize()
        for k in ("supervised_compress", "pca_monitor", "pca_project",
                  "pca_reconstruct"):
            assert ops.LAUNCHES[k] == 1, k
        for cpu, gpu in pairs:
            for a, b in zip(cpu, gpu):
                if a.dtype == torch.bool:
                    continue
                torch.testing.assert_close(b.cpu(), a, **tol)
        (_, xh, fl), (_, _, fl_g) = pairs[0]
        assert fl_g.dtype == torch.bool
        clear = ((x - xh).abs() - eps).abs() > 1e-4
        assert torch.equal(fl_g.cpu()[clear], fl[clear])

    @pytest.mark.parametrize("layout", ["row-major", "column-major"])
    @pytest.mark.parametrize("S,R,p,q", [
        (3, 29, 37, 3),        # ragged rows; p and q not multiples of 4
        (2, 256, 1024, 32),    # the slice
        (2, 64, 4096, 8),      # wsn-1m-smoke
        (2, 100, 1024, 48),    # q beyond one column tile
        (1, 16, 8192, 32),     # p beyond a block's shared memory as rows
    ])
    def test_project_reconstruct_match_plain(self, S, R, p, q, layout):
        """Kernels 8 and 9 alone, at their tile edges, against the plain
        versions on the same card tensors (cuBLAS's order of sums, TF32
        off): one launch each, no plain call, rtol/atol 1e-4.  The basis
        comes row-major, as the engine's refresh leaves it, or as QR's
        column-major Q, which the wrappers copy contiguous."""
        assert not torch.backends.cuda.matmul.allow_tf32
        g = torch.Generator().manual_seed(S * R + p + q)
        x = torch.randn((S, R, p), generator=g).cuda()
        basis = torch.linalg.qr(torch.randn((S, p, q), generator=g)).Q.cuda()
        if layout == "row-major":
            basis = basis.contiguous()
        assert basis.is_contiguous() == (layout == "row-major" or q == 1)
        ops.reset_counts()
        z = ops.pca_project(x, basis)
        xh = ops.pca_reconstruct(z, basis)
        torch.cuda.synchronize()
        assert ops.LAUNCHES["pca_project"] == 1
        assert ops.LAUNCHES["pca_reconstruct"] == 1
        assert sum(ops.LAUNCHES.values()) == 2
        assert sum(ops.PLAIN_CALLS.values()) == 0
        tol = dict(rtol=1e-4, atol=1e-4)
        assert z.shape == (S, R, q) and xh.shape == (S, R, p)
        torch.testing.assert_close(z, ref.pca_project(x, basis), **tol)
        torch.testing.assert_close(xh, ref.pca_reconstruct(z, basis), **tol)

    def test_reconstruct_refuses_q_beyond_shared_memory(self):
        """Kernel 9 keeps a block's scores in shared memory: q <= 224 on
        the H100, the limit the library reports."""
        z = torch.zeros((1, 4, 225), device="cuda")
        with pytest.raises(ValueError, match=r"q=225 .*\(q <= 224\)"):
            ops.pca_reconstruct(z, torch.zeros((1, 8, 225), device="cuda"))
        xh = ops.pca_reconstruct(z[..., :224].contiguous(),
                                 torch.ones((1, 8, 224), device="cuda"))
        assert torch.equal(xh, torch.zeros((1, 4, 8), device="cuda"))

    def test_per_round_mask_matches_per_row(self):
        S, K, n, p, q = 2, 4, 8, 37, 4
        x, basis, mean, il, m = _split_operands(S, K * n, p, q, True, n)
        args = [t.cuda() for t in (x, basis, mean, il)]
        per_round = ops.pca_monitor(*args, mask=m.cuda(), n=n)
        per_row = ops.pca_monitor(
            *args, mask=m.repeat_interleave(n, dim=1).cuda())
        for a, b in zip(per_round, per_row):
            assert torch.equal(a, b)


def _small_engine():
    """A 4-slot engine configuration at p=64 with compression and
    detection, five requests of three smooth local modes plus noise, and
    the slots' initial bases."""
    cfg = StreamConfig(p=64, q=4, halfwidth=3, forgetting=0.98,
                       warmup_rounds=3, drift_threshold=0.05,
                       compression=CompressionConfig(epsilon=1.0),
                       detection=DetectionConfig(alpha=1e-3, calib_rounds=2))
    rng = np.random.default_rng(7)
    j = np.arange(64)
    U = np.exp(-0.5 * ((j[:, None] - np.array([10, 30, 50])) / 1.5) ** 2)
    data = [(rng.normal(size=(r, 8, 3)) @ U.T + 0.05 * rng.normal(
        size=(r, 8, 64))).astype(np.float32) for r in (10, 13, 16, 9, 12)]
    return cfg, data, random_bases(4, 64, 4, seed=3, device="cpu")


@pytest.mark.cuda
def test_split_engines_on_card_match_fused_engine():
    """The split (``fused=False``) engine on the card against the fused
    engine on the card, same requests and bases: counts exactly, books
    rtol 1e-5, retained fraction rtol 1e-3 (refreshes go through Cholesky
    and eigh on the card in both); the quantized engine keeps ε."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    cfg, data, bases = _small_engine()
    results = {}
    for label, c in (("fused", cfg),
                     ("split", dataclasses.replace(cfg, fused=False)),
                     ("quant", dataclasses.replace(
                         cfg, compression=CompressionConfig(
                             epsilon=1.0, score_bits=8)))):
        eng = StreamingPCAEngine(c, slots=4, chunk=4, device="cuda",
                                 init_bases=bases)
        reqs = [StreamRequest(rounds=d) for d in data]
        for r in reqs:
            eng.submit(r)
        ops.reset_counts()
        eng.run_until_done()
        assert sum(ops.PLAIN_CALLS.values()) == 0
        results[label] = ([r.result for r in reqs], dict(ops.LAUNCHES))
    assert results["split"][1]["supervised_compress"] \
        == results["split"][1]["pca_monitor"] \
        == results["fused"][1]["fused_stream"] > 0
    assert results["quant"][1]["pca_project"] \
        == results["quant"][1]["pca_reconstruct"] > 0
    for a, b in zip(results["split"][0], results["fused"][0]):
        assert (a.rounds, a.refreshes, a.compression_extra_packets,
                a.detection_events) == (b.rounds, b.refreshes,
                                        b.compression_extra_packets,
                                        b.detection_events)
        np.testing.assert_allclose(a.comm_packets, b.comm_packets,
                                   rtol=1e-5)
        np.testing.assert_allclose(a.retained, b.retained, rtol=1e-3)
    for r in results["quant"][0]:
        assert r.compression_max_err <= 1.0


@pytest.mark.cuda
def test_bf16_engine_on_card_matches_cpu():
    """The fused engine in the bf16 tile mode on the card against the same
    engine on the CPU: one ``fused_stream_bf16`` launch a step and no
    plain call on the card; counts exactly, books rtol 1e-5, retained
    fraction rtol 1e-3; the sink error within ε plus the bf16 rounding of
    a reading (2⁻⁸·max|x|)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    cfg, data, bases = _small_engine()
    cfg = dataclasses.replace(cfg, precision="bf16")
    results = {}
    for dev in ("cuda", "cpu"):
        eng = StreamingPCAEngine(cfg, slots=4, chunk=4, device=dev,
                                 init_bases=bases, telemetry=True)
        reqs = [StreamRequest(rounds=d) for d in data]
        for r in reqs:
            eng.submit(r)
        ops.reset_counts()
        eng.run_until_done()
        if dev == "cuda":
            steps = sum(1 for s in eng.telemetry.steps if s.live > 0)
            assert ops.LAUNCHES["fused_stream_bf16"] == steps > 0
            assert ops.LAUNCHES["fused_stream"] == 0
            assert sum(ops.PLAIN_CALLS.values()) == 0
        results[dev] = [r.result for r in reqs]
    for a, b, d in zip(results["cuda"], results["cpu"], data):
        assert (a.rounds, a.refreshes, a.compression_extra_packets,
                a.detection_events) == (b.rounds, b.refreshes,
                                        b.compression_extra_packets,
                                        b.detection_events)
        np.testing.assert_allclose(a.comm_packets, b.comm_packets,
                                   rtol=1e-5)
        np.testing.assert_allclose(a.retained, b.retained, rtol=1e-3)
        assert a.compression_max_err <= 1.0 + 2.0 ** -8 * np.abs(d).max()


# (n, p, h) of test_round_fold_matches_plain: every n at every p and h, and
# the Berkeley fit's batch
_ROUND_SHAPES = [(n, p, h) for n in (13, 32, 33, 64, 65, 70, 129)
                 for p in (37, 64, 65, 1021, 1024)
                 for h in (0, 3, 128, "p+7")] + [(1440, 52, 15)]


def _round_operands(S, n, p, mask_kind, seed):
    """A round x (S, n, p) and a (S, p) liveness row, a (S, n, p) dropout
    mask or None, on the CPU."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((S, n, p), generator=g)
    m = {None: None,
         "live": (torch.rand((S, p), generator=g) > 0.2).float(),
         "drop": (torch.rand((S, n, p), generator=g) > 0.2).float(),
         }[mask_kind]
    return x, m


def _round_fold(x, h, m):
    """Kernel 6 or 7 on card tensors, launched twice: one count a call, no
    plain call, equal bits, an exactly symmetric band."""
    ops.reset_counts()
    band = ops.cov_band_update_batched(x, h, mask=m)
    again = ops.cov_band_update_batched(x, h, mask=m)
    torch.cuda.synchronize()
    kernel = ("band_round" if m is None else "band_round_masked"
              if m.dim() == 2 else "band_round_masked_drop")
    assert ops.LAUNCHES[kernel] == 2 and sum(ops.LAUNCHES.values()) == 2
    assert sum(ops.PLAIN_CALLS.values()) == 0
    assert torch.equal(band, again)
    _assert_mirrored(band, h)
    return band


def _chunk_at_k1(x, h, m):
    """Kernel 2 or 3 on the same round as a one-round chunk of weight 1."""
    return ops.cov_band_update_chunk_batched(
        x[:, None], torch.ones((x.shape[0], 1), device=x.device), h,
        mask=None if m is None else m[:, None])


@pytest.mark.cuda
class TestCudaRoundAndBandedKernels:
    """Kernels 6, 7, 10 and 11 against their plain versions, on the card."""

    @pytest.fixture(autouse=True)
    def _card(self):
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA card: the kernels have no CPU mode")

    @pytest.mark.parametrize("mask_kind", [None, "live", "drop"])
    @pytest.mark.parametrize("S", [1, 3])
    @pytest.mark.parametrize("n,p,h", _ROUND_SHAPES)
    def test_round_fold_matches_plain(self, n, p, h, S, mask_kind):
        """Kernels 6 and 7 at the tiles' edges, in each of their shapes
        (``ops.band_round_plan``): the round's shape up to 64 rows (one
        stage, exactly two, rounds that straddle stages: n = 13, 32, 33,
        64), and past it (n = 65, 70, 129: two or three segments of 64
        rows, the last partial) kernel 2's tile at unit weight, or the
        split fold for small bands on small grids (p = 37 with h = 0 or 3
        here, and the Berkeley fit's batch, n = 1,440 at p = 52, h = 15);
        odd p (4-byte copies), p below, at and across the 64-column tile;
        h from 0 past both ends of the band; one slot and three.  Against
        the plain version on the CPU (``TOL`` up to 32 rows, 1e-4 beyond,
        as the chunk folds), with an exactly symmetric band, equal bits on
        a second launch, one count a call, and kernel 2's or 3's bits at
        K = 1, w = 1."""
        h = _halfwidth(h, p)
        x, m = _round_operands(S, n, p, mask_kind,
                               p * 131 + h * 7 + n * 3 + S)
        cpu = ops.cov_band_update_batched(x, h, mask=m)
        xc, mc = x.cuda(), None if m is None else m.cuda()
        gpu = _round_fold(xc, h, mc)
        tol = TOL if n <= 32 else dict(rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(gpu.cpu(), cpu, **tol)
        # kernel 6/7 is kernel 2/3 at K = 1 with unit weight: same bits
        assert torch.equal(gpu, _chunk_at_k1(xc, h, mc))

    @pytest.mark.parametrize("fleet", [64, 160])
    @pytest.mark.parametrize("mask_kind", [None, "live", "drop"])
    @pytest.mark.parametrize("n,p,h", [(1440, 52, 15), (256, 1024, 128),
                                       (70, 1024, 128), (32, 1024, 128),
                                       (129, 37, 44)])
    def test_one_slot_bits_inside_a_fleet(self, n, p, h, mask_kind, fleet):
        """One slot's band is bit for bit the same alone (S = 1) and as
        each slot of a fleet of copies of it: the grid differs (and at
        n = 1,440 and 129 with 160 slots the shape too: split alone,
        kernel 2's tile in the fleet), the order of sums may not."""
        x, m = _round_operands(1, n, p, mask_kind, n + p + h)
        xc, mc = x.cuda(), None if m is None else m.cuda()
        copies = lambda t: None if t is None else \
            t.expand(fleet, *t.shape[1:]).contiguous()
        one = _round_fold(xc, h, mc)
        many = _round_fold(copies(xc), h, copies(mc))
        assert all(torch.equal(one[0], many[s]) for s in range(fleet))

    @pytest.mark.parametrize("mask_kind", [None, "live", "drop"])
    @pytest.mark.parametrize("S,n,p,h,shape", [
        (1, 1440, 52, 15, "split"), (2, 65, 37, 44, "split"),
        (4, 129, 65, 0, "split"), (1, 300, 96, 6, "split"),
        (3, 129, 1024, 128, "long"), (160, 129, 52, 15, "long"),
        (200, 65, 130, 0, "long"), (2, 200, 1021, 130, "long"),
        (1, 256, 16384, 128, "long")])
    def test_shapes_give_the_chunk_folds_bits(self, S, n, p, h, shape,
                                              mask_kind):
        """Past 64 rows, in the split fold (small bands on grids smaller
        than the card) and in kernel 2's tile at unit weight (everything
        else), kernels 6 and 7 give kernels 2 and 3's bits at K = 1,
        w = 1: the segments are summed in one order whatever the shape."""
        assert ops.band_round_plan(S, n, p, h).shape == shape
        x, m = _round_operands(S, n, p, mask_kind, S + n + p + h)
        xc, mc = x.cuda(), None if m is None else m.cuda()
        band = _round_fold(xc, h, mc)
        assert torch.equal(band, _chunk_at_k1(xc, h, mc))
        torch.testing.assert_close(
            band, ref.cov_band_update(xc, h, mc), rtol=1e-4, atol=1e-4)

    @pytest.mark.parametrize("precision", ["fp32", "bf16"])
    @pytest.mark.parametrize("masked", [False, True])
    @pytest.mark.parametrize("K,n", [(1, 100), (2, 129), (3, 70)])
    def test_fused_fold_equals_chunk_fold_past_a_segment(self, K, n, masked,
                                                         precision):
        """Kernel 1's fold blocks flush at segment ends as kernels 2 and 3
        do: its band equals theirs bit for bit on rounds of more than 64
        rows (two and three segments, the last partial), and at K = 1 it
        is kernel 6's or 7's."""
        S, p, h, q = 3, 130, 64, 4
        x, w, m = _fold_operands(S, K, n, p, "live" if masked else None, n)
        g = torch.Generator().manual_seed(n + K)
        basis = torch.linalg.qr(torch.randn((S, p, q), generator=g)).Q.cuda()
        out = ops.fused_stream_update(x, w, basis, halfwidth=h, epsilon=0.5,
                                      with_compress=True, with_monitor=True,
                                      mask=m, precision=precision)
        xt = ops.fused_tiles(x, precision).float()
        band = ops.cov_band_update_chunk_batched(xt, w, h, mask=m)
        torch.cuda.synchronize()
        assert torch.equal(out[0], band)
        if K == 1:
            ones = torch.ones((S, 1), device="cuda")
            out1 = ops.fused_stream_update(
                xt, ones, basis, halfwidth=h, epsilon=0.5,
                with_compress=True, with_monitor=True, mask=m)
            assert torch.equal(out1[0], ops.cov_band_update_batched(
                xt[:, 0], h, mask=None if m is None else m[:, 0]))

    @pytest.mark.parametrize("S,n,p,h", [(1, 1440, 52, 15), (4, 32, 1024, 128),
                                         (160, 129, 1024, 128),
                                         (2, 65, 37, 44)])
    def test_all_live_mask_gives_kernel_6(self, S, n, p, h):
        """Kernel 7 with a liveness row of ones gives kernel 6's bits in
        every shape (f = 1 x 1 = 1 at each segment's flush)."""
        x, _ = _round_operands(S, n, p, None, S + n)
        xc = x.cuda()
        ones = torch.ones((S, p), device="cuda")
        assert torch.equal(_round_fold(xc, h, ones), _round_fold(xc, h, None))

    @pytest.mark.parametrize("layout", ["contiguous", "transposed"])
    @pytest.mark.parametrize("q", [1, 3, 8, 32, 33, 40, 64])
    @pytest.mark.parametrize("p,h", [(37, 0), (37, 4), (37, 128), (37, 36),
                                     (130, 0), (130, 4), (130, 128),
                                     (1024, 0), (1024, 4), (1024, 128)])
    @pytest.mark.parametrize("S", [1, 3])
    def test_banded_products_match_plain(self, S, p, h, q, layout):
        """Kernel 10 with the tile it picks and with each tile named, and
        kernel 11: equal bits to the plain version, one launch a call.
        p = 130 is a multiple of neither tile's rows; h = 36 = p - 1 at
        p = 37 and h = 128 > p reach past both ends; q = 33, 40 and 64
        take two column tiles; a transposed V is not contiguous."""
        g = torch.Generator().manual_seed(S * 7919 + p * q + h)
        band = torch.randn((S, 2 * h + 1, p), generator=g)
        V = torch.randn((S, p, q), generator=g)
        if layout == "transposed":
            V = V.transpose(1, 2).contiguous().transpose(1, 2)
            assert not V.is_contiguous() or q == 1
        want = ref.banded_matmul(band, V)
        bc, vc = band.cuda(), V.cuda()
        ops.reset_counts()
        Y = ops.banded_matmul(bc, vc)
        y = ops.banded_matvec(bc, vc[..., 0])
        torch.cuda.synchronize()
        assert ops.LAUNCHES["banded_matmul"] == ops.LAUNCHES[
            "banded_matvec"] == 1
        assert sum(ops.PLAIN_CALLS.values()) == 0
        assert torch.equal(Y.cpu(), want)
        assert torch.equal(Y, ref.banded_matmul(bc, vc))
        assert torch.equal(y.cpu(), ref.banded_matvec(band, V[..., 0]))
        for tile in _TILES:
            assert torch.equal(_banded_tile(bc, vc, tile).cpu(), want), tile

    @pytest.mark.parametrize("tile", [None, *_TILES])
    def test_banded_matmul_at_the_refresh_shape(self, tile):
        """The refresh's shape (256 slots, p = 1024, h = 128, q = 32) with
        the tile the kernel picks and with each tile named: equal bits to
        the plain version on the card."""
        g = torch.Generator(device="cuda").manual_seed(10)
        band = torch.randn((256, 257, 1024), device="cuda", generator=g)
        V = torch.randn((256, 1024, 32), device="cuda", generator=g)
        ops.reset_counts()
        Y = ops.banded_matmul(band, V) if tile is None \
            else _banded_tile(band, V, tile)
        torch.cuda.synchronize()
        assert ops.LAUNCHES["banded_matmul"] == (1 if tile is None else 0)
        assert torch.equal(Y, ref.banded_matmul(band, V))


@pytest.mark.cuda
class TestCudaBandAccumulate:
    """Kernel 6's accumulating form (``ops.cov_band_accumulate``): the band
    it writes is ``band_in + `` the delta form's band bit for bit, in each
    of its shapes, every entry of a random non-symmetric ``band_in`` (the
    out-of-range corners too) checked, ``band_in`` left as it was."""

    @pytest.fixture(autouse=True)
    def _card(self):
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA card: the kernels have no CPU mode")

    @pytest.mark.parametrize("n,p,h,shape", [
        (32, 1024, 128, "round"), (256, 4096, 128, "long"),
        (1440, 52, 15, "split"), (13, 37, 3, "round"), (64, 65, 200, "round"),
        (65, 1021, 130, "long"), (129, 37, 44, "split"), (70, 1024, 0, "long"),
        (256, 16384, 128, "long")])
    def test_band_in_plus_delta_bit_for_bit(self, n, p, h, shape):
        assert ops.band_round_plan(1, n, p, h).shape == shape
        g = torch.Generator(device="cuda").manual_seed(n + p + h)
        band_in = torch.randn((2 * h + 1, p), device="cuda", generator=g)
        x = torch.randn((n, p), device="cuda", generator=g)
        before = band_in.clone()
        ops.reset_counts()
        out = ops.cov_band_accumulate(band_in, x, h)
        torch.cuda.synchronize()
        assert ops.LAUNCHES["band_round"] == 1
        assert sum(ops.LAUNCHES.values()) == 1
        assert ops.IN_KERNEL_ADDS["band_round"] == 1
        assert sum(ops.PLAIN_CALLS.values()) == 0
        assert torch.equal(band_in, before)
        assert torch.equal(out, band_in + ops.cov_band_update(x, h))
        assert torch.equal(out, ops.cov_band_accumulate(band_in, x, h))

    @pytest.mark.parametrize("n,p,h", [(32, 1024, 128), (256, 4096, 128),
                                       (1440, 52, 15)])
    def test_banded_update_keeps_its_bits(self, n, p, h):
        """``banded_update`` on the card (one launch, the add in it) gives
        the two-step form's state: ``band + delta``, ``s + x.sum(0)``."""
        from repro_torch.core import covariance as cov
        g = torch.Generator(device="cuda").manual_seed(n * p + h)
        state = cov.BandedCovState(
            t=torch.tensor(7.0, device="cuda"),
            s=torch.randn((p,), device="cuda", generator=g),
            band=torch.randn((2 * h + 1, p), device="cuda", generator=g),
            halfwidth=h)
        x = torch.randn((n, p), device="cuda", generator=g)
        ops.reset_counts()
        new = cov.banded_update(state, x)
        torch.cuda.synchronize()
        assert ops.LAUNCHES["band_round"] == 1
        assert ops.IN_KERNEL_ADDS["band_round"] == 1
        assert torch.equal(new.band, state.band + ops.cov_band_update(x, h))
        assert torch.equal(new.s, state.s + x.sum(0))
        assert float(new.t) == 7.0 + n


def _matvec_shape(band, v, shape):
    """Kernel 11 in ``shape``: "auto" through ``ops.banded_matvec`` (the
    plan's choice), "slot" or "thread" through that shape's C entry point;
    the output, or None where the entry refuses (a slot that does not fit
    its shared memory)."""
    if shape == "auto":
        return ops.banded_matvec(band, v)
    S, nb, p = band.shape
    entry = {"slot": "banded_matvec_slot_f32",
             "thread": "banded_matvec_f32"}[shape]
    y = torch.full((S, p), float("nan"), device=band.device)
    ret = getattr(build.load_library("banded"), entry)(
        band.data_ptr(), v.data_ptr(), S, p, (nb - 1) // 2, y.data_ptr(),
        torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    return None if ret != 0 else y


def _matvec_operands(S, p, h, offset, seed):
    """A (S, 2h+1, p) band whose out-of-range corners hold NaN (the
    kernel must never read them into a sum) and a (S, p) vector with one
    infinite entry (it may reach only the outputs whose in-range
    diagonals reach it), on the card; with ``offset`` each a view one
    float into its storage, so neither starts on a 16-byte boundary."""
    g = torch.Generator().manual_seed(seed)
    nb = 2 * h + 1
    band = torch.randn((S, nb, p), generator=g)
    band = torch.where(band_valid(p, h, device="cpu").bool(), band,
                       torch.tensor(float("nan")))
    v = torch.randn((S, p), generator=g)
    v[:, p // 3] = float("inf")
    if not offset:
        return band.cuda(), v.cuda()
    bs = torch.empty(S * nb * p + 1, device="cuda")
    vs = torch.empty(S * p + 1, device="cuda")
    bs[1:] = band.reshape(-1).cuda()
    vs[1:] = v.reshape(-1).cuda()
    return bs[1:].view(S, nb, p), vs[1:].view(S, p)


@pytest.mark.cuda
class TestCudaBandedMatvecShapes:
    """Kernel 11 in each shape of its plan (``ops.banded_matvec_plan``:
    "slot", the first port's "thread") and as the plan chooses, bit for
    bit with the plain version, one launch a call.  p = 1021 and 37 are
    long and short bands whose p is no multiple of 4."""

    @pytest.fixture(autouse=True)
    def _card(self):
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA card: the kernels have no CPU mode")

    @pytest.mark.parametrize("offset", [False, True])
    @pytest.mark.parametrize("S", [1, 3])
    @pytest.mark.parametrize("p,h", [(52, 15), (52, 51), (37, 0), (37, 4),
                                     (37, 128), (130, 4), (130, 128),
                                     (1021, 128), (1024, 0), (1024, 128),
                                     (4096, 8)])
    @pytest.mark.parametrize("shape", ["auto", "slot", "thread"])
    def test_each_shape_gives_the_plain_bits(self, shape, p, h, S, offset):
        """p % 4 != 0 (37, 1021: 4-byte copies), h = 0, h >= p (every
        output at an edge), one slot and three, band and v off 16-byte
        alignment (4-byte copies), NaN in the band's corners and an
        infinite v entry: equal bits to ``ref.banded_matvec``, which
        never reads the corners; a slot past its shared memory is
        refused."""
        band, v = _matvec_operands(S, p, h, offset, S * p + h)
        assert offset == (band.data_ptr() % 16 != 0)
        y = _matvec_shape(band, v, shape)
        if shape == "slot" and ops._matvec_slot_bytes(p, h) > \
                ops.MATVEC_SLOT_MAX_BYTES:
            assert y is None
            return
        assert torch.equal(y, ref.banded_matvec(band, v))

    @pytest.mark.parametrize("offset", [False, True])
    def test_wrapper_one_launch_off_alignment(self, offset):
        """``ops.banded_matvec`` on views one float into their storage
        (the wrapper copies nothing: they are contiguous): one launch,
        no plain call, the plain bits."""
        for S, p, h in ((1, 52, 15), (3, 1024, 128), (2, 37, 128)):
            band, v = _matvec_operands(S, p, h, offset, p + h)
            ops.reset_counts()
            y = ops.banded_matvec(band, v)
            torch.cuda.synchronize()
            assert ops.LAUNCHES["banded_matvec"] == 1
            assert sum(ops.PLAIN_CALLS.values()) == 0
            assert torch.equal(y, ref.banded_matvec(band, v))

    @pytest.mark.parametrize("S,p,shape", [(32, 6144, "slot"),
                                           (32, 6145, "thread"),
                                           (131, 52, "slot"),
                                           (132, 52, "thread")])
    def test_boundary_between_slot_and_thread(self, S, p, shape):
        """The slot shape holds up to p = 6,144 at h = 0 (49,152 bytes)
        and grids of up to 131 slots on the card's 132 SMs; past either,
        the first port's tile.  Both sides give the plain bits in every
        shape that fits."""
        h = 0 if p > 52 else 15
        band, v = _matvec_operands(S, p, h, False, p)
        want = ref.banded_matvec(band, v)
        assert ops.banded_matvec_plan(S, p, h).shape == shape
        for named in ("auto", "slot", "thread"):
            y = _matvec_shape(band, v, named)
            if named == "slot" and p == 6145:
                assert y is None
            else:
                assert torch.equal(y, want), named

    def test_refresh_band_bits(self):
        """The refresh's band (256 slots, p = 1024, h = 128; the first
        port's tile): the plain bits."""
        g = torch.Generator(device="cuda").manual_seed(11)
        band = torch.randn((256, 257, 1024), device="cuda", generator=g)
        v = torch.randn((256, 1024), device="cuda", generator=g)
        ops.reset_counts()
        y = ops.banded_matvec(band, v)
        torch.cuda.synchronize()
        assert ops.LAUNCHES["banded_matvec"] == 1
        assert torch.equal(y, ref.banded_matvec(band, v))


# the paper pipeline's one-slot shapes: the Berkeley deployment (p = 52,
# p % 4 != 0; h its RCM bandwidth and one near p), WSNConfig.smoke()
# (4096, 8) and wsn-1m (p = 1,048,576, h = 128: (2h+1) p and 256 p near
# 2^28, so every index product must be wide)
_PAPER_SHAPES = [(52, 15), (52, 51), (4096, 8), (1_048_576, 128)]


@pytest.mark.cuda
class TestCudaPaperShapes:
    """Kernels 6, 10 and 11 at one slot (S = 1) on the paper pipeline's
    widths, as ``repro_torch.core`` launches them (no leading axis)."""

    @pytest.fixture(autouse=True)
    def _card(self):
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA card: the kernels have no CPU mode")

    @pytest.mark.parametrize("p,h", _PAPER_SHAPES)
    def test_batch_fold(self, p, h):
        """Kernel 6 on a 256-epoch batch: 1e-4 against the plain version
        on the card (256 products a pair), exactly symmetric, and kernel
        2's bits at K = 1, w = 1."""
        g = torch.Generator(device="cuda").manual_seed(p + h)
        x = torch.randn((256, p), device="cuda", generator=g)
        ops.reset_counts()
        band = ops.cov_band_update(x, h)
        torch.cuda.synchronize()
        assert ops.LAUNCHES["band_round"] == 1
        assert sum(ops.PLAIN_CALLS.values()) == 0
        _assert_mirrored(band[None], h)
        torch.testing.assert_close(band, ref.cov_band_update(x, h),
                                   rtol=1e-4, atol=1e-4)
        chunk = ops.cov_band_update_chunk_batched(
            x[None, None], torch.ones((1, 1), device="cuda"), h)[0]
        assert torch.equal(band, chunk)

    @pytest.mark.parametrize("q", [1, 5, 8, 32])
    @pytest.mark.parametrize("p,h", _PAPER_SHAPES)
    def test_banded_products(self, p, h, q):
        """Kernels 10 and 11 on an in-range band: equal bits to the plain
        version on the card, one launch each."""
        g = torch.Generator(device="cuda").manual_seed(p * q + h)
        band = torch.randn((2 * h + 1, p), device="cuda", generator=g) \
            * band_valid(p, h, device="cuda")
        V = torch.randn((p, q), device="cuda", generator=g)
        ops.reset_counts()
        Y = ops.banded_matmul(band, V)
        y = ops.banded_matvec(band, V[:, 0].contiguous())
        torch.cuda.synchronize()
        assert ops.LAUNCHES["banded_matmul"] == ops.LAUNCHES[
            "banded_matvec"] == 1
        assert sum(ops.PLAIN_CALLS.values()) == 0
        assert torch.equal(Y, ref.banded_matmul(band, V))
        assert torch.equal(y, ref.banded_matvec(band, V[:, 0]))

    @pytest.mark.parametrize("method", ["power", "ortho"])
    def test_banded_fit_on_card_matches_cpu(self, method):
        """DistributedPCA's banded fit on the card against the same fit on
        the CPU, from the same start: iteration counts and ``valid``
        equal, eigenvalues rtol 1e-4, components |cos| >= 1 - 1e-4; kernel
        6 once, and kernel 11 once an iteration ('power') or kernel 10
        once an iteration and once more ('ortho'); no plain call."""
        from repro_torch.core.pca import DistributedPCA
        rng = np.random.default_rng(3)
        p, h, q = 300, 6, 4
        x = rng.standard_normal((400, p)).astype(np.float32)
        x[:, 1:] += 0.7 * x[:, :-1]
        init = (rng.standard_normal((q, p)) if method == "power"
                else rng.standard_normal((p, q))).astype(np.float32)
        fits = {}
        for dev in ("cpu", "cuda"):
            ops.reset_counts()
            fits[dev] = DistributedPCA(q, method=method, cov_mode="banded",
                                       halfwidth=h, init=init,
                                       device=dev).fit(x)
        a, b = fits["cuda"], fits["cpu"]
        iters = int(np.sum(a.iterations))
        want = {"band_round": 1, "banded_matvec": iters} \
            if method == "power" else {"band_round": 1,
                                       "banded_matmul": iters + 1}
        assert {k: v for k, v in ops.LAUNCHES.items() if v} == want
        assert sum(ops.PLAIN_CALLS.values()) == 0
        np.testing.assert_array_equal(a.iterations, b.iterations)
        np.testing.assert_array_equal(a.valid, b.valid)
        np.testing.assert_allclose(a.eigenvalues, b.eigenvalues, rtol=1e-4)
        cos = np.abs((a.components * b.components).sum(0))
        assert cos.min() >= 1 - 1e-4


def _fleet_data(N, R, n, p, seed):
    """Three smooth local modes that move half way through the stream
    (drift, so the scheduler refreshes again), small noise, and a few
    +-5 spikes: reconstruction errors stay far from eps = 1 except at the
    spikes, so flags cannot flip between the card and the CPU."""
    rng = np.random.default_rng(seed)
    j = np.arange(p)

    def modes(centres):
        return np.exp(-0.5 * ((j[:, None] - np.array(centres) * p)
                              / 1.5) ** 2)
    g = 0.1 * rng.normal(size=(N, R, n, 3))
    xs = g @ modes([0.2, 0.5, 0.8]).T
    xs[:, R // 2:] = g[:, R // 2:] @ modes([0.35, 0.65, 0.9]).T
    xs += 0.05 * rng.normal(size=xs.shape)
    spikes = rng.random(xs.shape) < 2e-3
    xs += spikes * np.where(rng.random(xs.shape) < 0.5, -5.0, 5.0)
    return torch.from_numpy(xs.astype(np.float32))


@pytest.mark.cuda
def test_per_round_run_is_one_round_chunk_run_on_card():
    """A band-only fleet of 8 networks on the card: ``chunk=None``
    (kernel 6 a round) and ``chunk=1`` (kernel 2 a round) give equal band
    bits and equal decisions — the kernels' products are equal bit for
    bit and the rest of the step is shared."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    cfg = StreamConfig(p=64, q=4, halfwidth=3, forgetting=0.98,
                       warmup_rounds=3, drift_threshold=0.05)
    xs = _fleet_data(8, 12, 8, 64, 11).cuda()
    bases = random_bases(8, 64, 4, seed=5, device="cpu")
    runs = {}
    for chunk in (None, 1):
        ops.reset_counts()
        st = batched_stream_init(cfg, 8, W0=bases, device="cuda")
        runs[chunk] = batched_stream_run(cfg, st, xs, chunk=chunk)
        torch.cuda.synchronize()
        fold = "band_round" if chunk is None else "band_fold"
        assert ops.LAUNCHES[fold] == 12
        assert ops.LAUNCHES["banded_matmul"] == 12 * (cfg.refresh_iters + 3)
        assert sum(ops.PLAIN_CALLS.values()) == 0
    (a, ma), (b, mb) = runs[None], runs[1]
    assert torch.equal(a.cov.band, b.cov.band)
    assert torch.equal(ma.did_refresh, mb.did_refresh)
    assert int(ma.did_refresh.sum()) > 8
    same = lambda u, v: torch.testing.assert_close(u, v, rtol=0, atol=0)
    tree_map(same, a, b)
    tree_map(same, ma, mb)


@pytest.mark.cuda
def test_per_round_stage_run_on_card_matches_cpu():
    """The per-round fleet path with compression, detection and liveness
    masks on the card against the same run on the CPU: decisions and
    counts exactly, books rtol 1e-5, retained fraction rtol 1e-3
    (refreshes go through Cholesky and eigh on both sides)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    cfg = StreamConfig(p=64, q=4, halfwidth=3, forgetting=0.98,
                       warmup_rounds=3, drift_threshold=0.05,
                       compression=CompressionConfig(epsilon=1.0),
                       detection=DetectionConfig(alpha=1e-3, calib_rounds=2))
    xs = _fleet_data(4, 12, 8, 64, 12)
    masks = torch.ones((4, 12, 64))
    masks[3, 6:, 20:28] = 0.0
    bases = random_bases(4, 64, 4, seed=6, device="cpu")
    out = {}
    for dev in ("cuda", "cpu"):
        ops.reset_counts()
        st = batched_stream_init(cfg, 4, W0=bases, device=dev)
        out[dev] = batched_stream_run(cfg, st, xs.to(dev), masks.to(dev))
        if dev == "cuda":
            torch.cuda.synchronize()
            for k in ("band_round_masked", "supervised_compress",
                      "pca_monitor"):
                assert ops.LAUNCHES[k] == 12, k
            assert sum(ops.PLAIN_CALLS.values()) == 0
    (g, mg), (c, mc) = out["cuda"], out["cpu"]
    assert torch.equal(mg.did_refresh.cpu(), mc.did_refresh)
    assert torch.equal(mg.compression.extra_packets.cpu(),
                       mc.compression.extra_packets)
    assert torch.equal(mg.detection.alarms.cpu(), mc.detection.alarms)
    torch.testing.assert_close(mg.comm_packets.cpu(), mc.comm_packets,
                               rtol=1e-5, atol=0)
    torch.testing.assert_close(mg.rho.cpu(), mc.rho, rtol=1e-3, atol=1e-6)
    assert float(mg.compression.max_err.max()) <= 1.0


# -- the pipelined engine on the card ----------------------------------------
def _pipeline_run(pipeline, *, poison=False, debug_sites=None):
    """The small engine with a liveness request and two submission waves,
    synchronous or pipelined.  With ``poison`` every staging buffer is
    overwritten after each step, once its last upload's event has
    completed; with ``debug_sites`` (a list) the host syncs of every step
    after the first are recorded under set_sync_debug_mode("warn")."""
    cfg, data, bases = _small_engine()
    eng = StreamingPCAEngine(cfg, slots=4, chunk=4, device="cuda",
                             init_bases=bases, pipeline=pipeline)
    live = np.ones((16, 64), np.float32)
    live[6:, 20:28] = 0.0
    reqs = [StreamRequest(rounds=d, region=i,
                          liveness=live[:len(d)] if i == 2 else None)
            for i, d in enumerate(data)]
    for r in reqs[:3]:
        eng.submit(r)
    ops.reset_counts()
    step = 0
    while True:
        if step == 2:
            for r in reqs[3:]:
                eng.submit(r)
        if debug_sites is not None and step > 0:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    live_slots = eng.step()
                finally:
                    torch.cuda.set_sync_debug_mode("default")
            debug_sites.extend(
                linecache.getline(w.filename, w.lineno).strip()
                for w in caught
                if "called a synchronizing" in str(w.message))
        else:
            live_slots = eng.step()
        if poison:
            for bufs in eng._staging:
                if bufs is not None:
                    if bufs.upload is not None:
                        bufs.upload.synchronize()
                    for buf in bufs.views():
                        buf.fill(np.float32(1e9))
        step += 1
        if not live_slots and not eng.queue:
            break
    assert sum(ops.PLAIN_CALLS.values()) == 0
    return eng, reqs, dict(ops.LAUNCHES)


def _same_results(ra, rb):
    for a, b in zip(ra, rb, strict=True):
        assert a.done and b.done
        for x, y in zip(a.retirements + [a.result],
                        b.retirements + [b.result], strict=True):
            for f in dataclasses.fields(x):
                np.testing.assert_array_equal(np.asarray(getattr(x, f.name)),
                                              np.asarray(getattr(y, f.name)),
                                              err_msg=f.name)


@pytest.mark.cuda
class TestCudaPipelinedEngine:
    @pytest.fixture(autouse=True)
    def _card(self):
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA card: the kernels have no CPU mode")

    def test_pipelined_is_sync_bit_for_bit(self):
        e_sync, r_sync, l_sync = _pipeline_run(False)
        e_pipe, r_pipe, l_pipe = _pipeline_run(True)
        _same_results(r_sync, r_pipe)
        ledger = lambda eng, reqs: [(reqs.index(q), why)
                                    for q, why in eng.retired_log]
        assert ledger(e_sync, r_sync) == ledger(e_pipe, r_pipe)
        assert l_sync == l_pipe and l_pipe["fused_stream"] > 0
        assert e_pipe.pulls["hot"] == 0 and e_pipe._prestage_hits >= 1
        assert e_pipe.pulls["retire"] == len(e_pipe.retired_log)

    def test_buffers_pinned_and_copy_stream_a_side_stream(self):
        eng, _, _ = _pipeline_run(True)
        sources = [t for bufs in eng._staging for t in bufs.sources]
        assert len(sources) == 6
        assert all(t.is_pinned() and t.device.type == "cpu"
                   for t in sources)
        for bufs in eng._staging:
            for view, t in zip(bufs.views(), bufs.sources, strict=True):
                assert view.ctypes.data == t.data_ptr()   # views, not copies
        assert eng._copy_stream is not None
        assert eng._copy_stream != torch.cuda.current_stream()
        assert eng._copy_stream != torch.cuda.default_stream()
        assert all(isinstance(bufs.upload, torch.cuda.Event)
                   for bufs in eng._staging)

    def test_loop_syncs_only_at_the_named_sites(self):
        """Between the dispatch of a step and the end of the prestage the
        host waits for the card only where PERF.md says: the refresh's
        ``eigh`` and the retirement pull (the transfer fence, an
        ``Event.synchronize`` on a copy, is never flagged)."""
        sites = []
        _pipeline_run(True, debug_sites=sites)
        allowed = ("torch.linalg.eigh", "x.cpu()")
        assert sites, "no sync recorded: is the debug mode on?"
        stray = [s for s in sites if not any(a in s for a in allowed)]
        assert not stray, stray

    @pytest.mark.parametrize("pipeline", [False, True])
    def test_poisoned_buffers_after_their_copies_change_nothing(self,
                                                                pipeline):
        _, clean, _ = _pipeline_run(pipeline)
        _, poisoned, _ = _pipeline_run(pipeline, poison=True)
        _same_results(clean, poisoned)

    def test_fleet_summary_on_card_matches_cpu(self):
        """The merge on the card against the same engine's merge on the
        CPU: selection exactly, energies and rho rtol 1e-5, the basis
        (sign-aligned) atol 1e-4, one merge pull each.  Each region's
        readings carry a gain of its own, so the ranking across regions
        has a margin."""
        cfg, data, bases = _small_engine()
        summaries = {}
        for dev in ("cuda", "cpu"):
            eng = StreamingPCAEngine(cfg, slots=4, chunk=4, device=dev,
                                     init_bases=bases, pipeline=True)
            for i, d in enumerate(data):
                eng.submit(StreamRequest(rounds=d * np.float32(1 + 0.3 * i),
                                         region=i))
            eng.run_until_done()
            summaries[dev] = eng.fleet_summary(8)
            assert eng.pulls["merge"] == 1
        a, b = summaries["cuda"], summaries["cpu"]
        np.testing.assert_array_equal(a.region, b.region)
        np.testing.assert_array_equal(a.col, b.col)
        np.testing.assert_allclose(a.lam, b.lam, rtol=1e-5)
        np.testing.assert_allclose(a.rho, b.rho, rtol=1e-5)
        sgn = np.sign(np.sum(a.basis * b.basis, axis=0))
        np.testing.assert_allclose(a.basis * sgn, b.basis, atol=1e-4)
        assert a.merge_packets == b.merge_packets


@pytest.mark.cuda
class TestCudaChecker:
    """``python -m repro_torch.analysis.check --device cuda``: every
    contract at the engine's widths (the engine's with the host syncs by
    call site), every kernel call one pass, and the resource bill within
    the H100's limits and equal to the committed baseline."""

    @pytest.fixture(autouse=True)
    def _card(self):
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA card: the kernels have no CPU mode")

    def test_checker_passes_on_the_card(self):
        from repro_torch.analysis import check
        rows = check.run_checks("cuda", echo=lambda line: None)
        bad = [f"{r['contract']}/{r['rule']}: {r['detail']}"
               for r in rows if not r["ok"]]
        assert not bad, bad
        assert any(r["rule"].startswith("syncs[") for r in rows)

    def test_resource_bill_equals_baseline(self):
        from repro_torch.analysis import resources
        rows = resources.check_card("cuda")
        assert any(r.rule.startswith("baseline:launch[") for r in rows)
        bad = [r.line() for r in rows if not r.ok]
        assert not bad, bad

    def test_examples_pass_their_gates_on_the_card(self):
        from repro_torch.examples import event_fleet, streaming_pca
        ops.reset_counts()
        r = streaming_pca.run("cuda")
        assert r["total_refreshes"] >= 1
        assert ops.LAUNCHES["band_round"] == streaming_pca.N_ROUNDS
        assert sum(ops.PLAIN_CALLS.values()) == 0
        r = event_fleet.run("cuda")
        assert r["tpr"] > 0.8 and r["fpr"] < 0.05


@pytest.mark.cuda
def test_compressed_train_step_on_card_matches_cpu():
    """One rank-4 PowerSGD training step of granite-moe-3b-a800m's smoke
    MoE (fp32, TF32 off, no warm-up) from the same weights, Q factors and
    tokens on the card and on the CPU: the step's loss within rtol 1e-5
    (the same sums in another order); AdamW's moments, the Q factors and
    the error buffers after it within 1e-4 of each leaf's largest
    magnitude on the CPU, as the CPU tests hold the port's PowerSGD to the
    reference, and the parameters too at all but 3e-5 of their elements
    (AdamW moves a weight by about lr whatever its gradient's size, so a
    gradient within roundoff of 0 may move it one way on the card and the
    other on the CPU: 1 element of 254,784 measured on the H100); the
    next batch's loss under the updated weights within rtol 1e-5; a
    second card run equal to the bit, state and all."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the training step runs on it")
    from repro_torch import configs
    from repro_torch.convert import (lm_params_from_numpy,
                                     lm_params_to_numpy,
                                     train_state_to_numpy)
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.distributed.compression import init_compressor
    from repro_torch.models import transformer as T
    from repro_torch.models.params import tree_leaves
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.trainer import TrainConfig, Trainer

    cfg = configs.get("granite-moe-3b-a800m").smoke()
    host = T.init_params(cfg, 5, device="cpu")
    weights = lm_params_to_numpy(host)
    q = {k: v.numpy() for k, v in tree_leaves(
        init_compressor(host, 4, torch.Generator().manual_seed(6)).q)
        if v is not None}
    tcfg = TrainConfig(optimizer=AdamWConfig(lr=1e-3), warmup_steps=0,
                       total_steps=10, compress_rank=4, remat=True)
    nxt = torch.tensor(TokenPipeline(cfg.vocab_size, 64, 4, seed=0)
                       .batch_at(1))
    out = []
    for dev in ("cuda", "cpu", "cuda"):
        tr = Trainer(cfg, tcfg, TokenPipeline(cfg.vocab_size, 64, 4, seed=0),
                     device=dev,
                     params=lm_params_from_numpy(cfg, weights, dev), q=q)
        loss = tr.run(1, log_every=0)[0]["loss"]
        with torch.no_grad():
            after, _ = T.lm_loss(tr.state.params, cfg,
                                 {"tokens": nxt.to(dev)})
        out.append((loss, float(after), train_state_to_numpy(tr.state)))
    (lc, ac, sc), (lh, ah, sh), (lc2, ac2, sc2) = out
    assert lc == pytest.approx(lh, rel=1e-5)
    assert ac == pytest.approx(ah, rel=1e-5)
    assert sorted(sc) == sorted(sh)
    for part in ("params.", "opt.mu.", "opt.nu.", "comp.q.", "comp.error."):
        assert any(k.startswith(part) for k in sh), part
    beyond = size = 0
    for k, v in sh.items():
        gap = np.abs(sc[k] - v) / (np.abs(v).max() or 1.0)
        if k.startswith("params."):
            beyond += int(np.count_nonzero(gap > 1e-4))
            size += v.size
        else:
            np.testing.assert_array_less(gap, 1e-4, err_msg=k)
    assert beyond <= 3e-5 * size, (beyond, size)
    assert (lc, ac) == (lc2, ac2)
    for k in sc:
        np.testing.assert_array_equal(sc[k], sc2[k], err_msg=k)


@pytest.mark.cuda
class TestCudaLMFamilies:
    """The SSM, hybrid and encoder-decoder families on the card against
    the CPU at their smoke widths, fp32, TF32 off, from the same weights
    (drawn on the CPU) and tokens: ``forward``'s logits, a 24-token
    ``prefill`` and 5 ``decode_step``s fed the CPU's greedy tokens (logits
    within rtol/atol 1e-4: the same sums in other orders), every cache
    leaf within 1e-4 of its largest magnitude on the CPU and the
    positions exactly; for ssm and hybrid, an Engine on the card gives
    the CPU engine's tokens."""

    ARCHS = ("mamba2-2.7b", "hymba-1.5b", "seamless-m4t-medium")

    @pytest.fixture(autouse=True)
    def _card(self):
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA card: the models run on it")
        tf32 = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        yield
        torch.backends.cuda.matmul.allow_tf32 = tf32

    def _weights(self, arch):
        from repro_torch import configs
        from repro_torch.models import transformer as T
        from repro_torch.models.params import tree_map
        cfg = configs.get(arch).smoke()
        host = T.init_params(cfg, 7, device="cpu")
        return cfg, host, tree_map(lambda a: a.cuda(), host)

    @pytest.mark.parametrize("arch", ARCHS)
    def test_family_on_card_matches_cpu(self, arch):
        from repro_torch.convert import decode_state_to_numpy
        from repro_torch.models import transformer as T
        cfg, host, card = self._weights(arch)
        rng = np.random.default_rng(8)
        toks = torch.tensor(rng.integers(0, cfg.vocab_size, (2, 24)))
        enc = (torch.tensor(rng.normal(size=(2, 10, cfg.d_model)),
                            dtype=torch.float32)
               if cfg.family == "encdec" else None)
        out = {}
        for dev, params in (("cpu", host), ("cuda", card)):
            e = None if enc is None else enc.to(dev)
            fwd, _ = T.forward(params, cfg, toks.to(dev), enc_input=e)
            state = T.init_decode_state(cfg, 2, 40, dtype=torch.float32,
                                        device=dev, enc_len=10)
            logits, state = T.prefill(params, cfg, toks.to(dev), state,
                                      enc_input=e)
            seq = [logits.cpu()]
            nxt = out["cpu"][2][0].argmax(-1, keepdim=True) \
                if dev == "cuda" else logits.argmax(-1, keepdim=True).cpu()
            for i, t in enumerate(range(24, 29)):
                logits, state = T.decode_step(params, cfg, nxt.to(dev),
                                              state, t)
                seq.append(logits.cpu())
                nxt = (out["cpu"][2][i + 1] if dev == "cuda"
                       else logits.cpu()).argmax(-1, keepdim=True)
            out[dev] = (fwd.cpu(), decode_state_to_numpy(state), seq)
        (fh, sh, qh), (fc, sc, qc) = out["cpu"], out["cuda"]
        torch.testing.assert_close(fc, fh, rtol=1e-4, atol=1e-4)
        for a, b in zip(qc, qh):
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
        assert sorted(sc) == sorted(sh)
        for k, v in sh.items():
            if k.endswith("pos"):
                np.testing.assert_array_equal(sc[k], v)
            else:
                np.testing.assert_allclose(
                    sc[k], v, rtol=0, atol=1e-4 * (np.abs(v).max() or 1.0),
                    err_msg=k)

    @pytest.mark.parametrize("arch", ARCHS[:2])
    def test_engine_on_card_matches_cpu(self, arch):
        from repro_torch.serve.engine import Engine, Request, ServeConfig
        cfg, host, card = self._weights(arch)
        rng = np.random.default_rng(9)
        prompts = [rng.integers(0, cfg.vocab_size, s).astype(np.int32)
                   for s in (3, 17, 9, 26, 5)]
        outs = []
        for dev, params in (("cpu", host), ("cuda", card)):
            eng = Engine(cfg, params, ServeConfig(slots=2, max_len=40),
                         device=dev)
            reqs = [Request(prompt=p, max_new_tokens=6) for p in prompts]
            for r in reqs:
                eng.submit(r)
            eng.run_until_done()
            assert all(r.done for r in reqs)
            outs.append([r.output for r in reqs])
        assert outs[0] == outs[1]


@pytest.mark.cuda
class TestCudaLaunch:
    """``repro_torch.launch`` on the card: the block plan's q limits equal
    the C entries' (276, 208, 276, 224 on the H100), and ``dryrun --smoke``
    on a one-rank NCCL mesh launches kernels 6, 10 and 11 with no plain
    call, each cell within 1e-6 of the unsharded step run through the
    kernels' plain versions on CPU copies of its operands."""

    @pytest.fixture(autouse=True)
    def _card(self):
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA card: the kernels have no CPU mode")

    def test_tiling_q_limits_match_the_entries(self):
        from repro_torch.kernels.build import load_library
        from repro_torch.launch import tiling
        dev = torch.cuda.current_device()
        optin = torch.cuda.get_device_properties(dev) \
            .shared_memory_per_block_optin
        fused = load_library("fused_stream")
        split = load_library("pca_project")
        got = {"fused_stream": fused.fused_stream_max_q(dev, 0),
               "fused_stream_bf16": fused.fused_stream_max_q(dev, 1),
               "stage_tile": split.stage_tile_max_q(dev),
               "pca_reconstruct": split.pca_reconstruct_max_q(dev)}
        for entry, q in got.items():
            assert q == tiling.max_q(entry, optin), entry
        if optin == tiling.SMEM_BYTES:
            assert list(got.values()) == [276, 208, 276, 224]

    def test_dryrun_smoke_on_card(self):
        from repro_torch.launch import dryrun as D
        want = {"cov_update": {"band_round": 1},
                "pim_block": {"banded_matmul": 1},
                "pim_deflated": {"banded_matvec": 1},
                "transform": {}, "hier_merge": {}}
        for shape, launches in want.items():
            rec = D.run_cell("wsn-1m", shape, False, smoke=True,
                             device="cuda")
            assert rec["ok"], rec.get("error")
            assert rec["max_rel_err"] <= D.SMOKE_RTOL, shape
            assert rec["launches"] == launches, (shape, rec["launches"])
            assert rec["plain_calls"] == {}, shape


@pytest.mark.cuda
class TestCudaLMPort:
    """The pipeline schedule, a family's training step and the parameter
    draw on the card: ``pipeline_apply`` on a one-rank NCCL group equal,
    bit for bit, to the layer function applied microbatch by microbatch
    (llama3.2-1b's smoke layers, bf16, forward and every gradient); one
    rank-4 PowerSGD training step of the SSM, hybrid and encoder-decoder
    smoke configs (fp32, TF32 off; encdec's batch with encoder frames)
    card vs CPU as ``test_compressed_train_step_on_card_matches_cpu``
    holds granite's; and ``init_params`` of a schema whose stacked leaf
    passes the draw limit (patched low) peaks under the leaf in bf16 plus
    one fp32 slice, beside what is held before it."""

    @pytest.fixture(autouse=True)
    def _card(self):
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA card: the models run on it")
        tf32 = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        yield
        torch.backends.cuda.matmul.allow_tf32 = tf32

    def test_one_rank_pipeline_bit_for_bit(self, tmp_path):
        import torch.distributed as dist
        from repro_torch import configs
        from repro_torch.distributed.pipeline import pipeline_apply
        from repro_torch.launch.mesh import init_fleet_process_group
        from repro_torch.models import transformer as T
        from repro_torch.models.params import tree_leaves, unflatten
        cfg = dataclasses.replace(configs.get("llama3.2-1b").smoke(),
                                  n_layers=3, dtype="bfloat16")
        flat = [(k, v) for k, v in tree_leaves(T.init_params(
            cfg, 4, device="cuda")["layers"])]
        gen = torch.Generator(device="cuda").manual_seed(5)
        x0 = torch.randn((8, 16, cfg.d_model), device="cuda",
                         generator=gen).to(torch.bfloat16)
        cot = torch.randn(x0.shape, device="cuda", generator=gen)
        pos = torch.arange(16, device="cuda")

        def layer(p, h):
            for lp in T._unstack(p, cfg.n_layers):
                h, _ = T._layer_fwd(cfg, h, lp, pos, 0)
            return h

        def run(piped):
            leaves = [v.detach().requires_grad_(True) for _, v in flat]
            p = unflatten({k: v for (k, _), v in zip(flat, leaves)})
            x = x0.clone().requires_grad_(True)
            y = (pipeline_apply(layer, p, x, n_microbatches=4,
                                group=dist.group.WORLD) if piped
                 else torch.cat([layer(p, m) for m in x.chunk(4)]))
            return [y.detach(), *torch.autograd.grad(
                (y.float() * cot).sum(), [x, *leaves])]

        init_fleet_process_group(0, 1, tmp_path, device="cuda",
                                 timeout_s=120)
        try:
            piped, plain = run(True), run(False)
        finally:
            dist.destroy_process_group()
        for a, b in zip(piped, plain):
            assert torch.equal(a, b)

    @pytest.mark.parametrize("arch", ["mamba2-2.7b", "hymba-1.5b",
                                      "seamless-m4t-medium"])
    def test_family_train_step_on_card_matches_cpu(self, arch):
        from repro_torch import configs
        from repro_torch.convert import (lm_params_from_numpy,
                                         lm_params_to_numpy,
                                         train_state_to_numpy)
        from repro_torch.distributed.compression import init_compressor
        from repro_torch.models import transformer as T
        from repro_torch.models.params import tree_leaves
        from repro_torch.train.optimizer import AdamWConfig
        from repro_torch.train.trainer import (TrainConfig, TrainState,
                                               make_train_step)
        cfg = configs.get(arch).smoke()
        host = T.init_params(cfg, 5, device="cpu")
        weights = lm_params_to_numpy(host)
        q = {k: v.numpy() for k, v in tree_leaves(
            init_compressor(host, 4, torch.Generator().manual_seed(6)).q)
            if v is not None}
        tcfg = TrainConfig(optimizer=AdamWConfig(lr=1e-3), warmup_steps=0,
                           total_steps=10, compress_rank=4, remat=True)
        rng = np.random.default_rng(6)
        batch = {"tokens": torch.tensor(rng.integers(0, cfg.vocab_size,
                                                     (4, 24)))}
        if cfg.family == "encdec":
            batch["enc_input"] = torch.tensor(
                rng.normal(size=(4, 10, cfg.d_model)), dtype=torch.float32)
        out = {}
        for dev in ("cuda", "cpu"):
            state = TrainState.create(cfg, tcfg, device=dev, q=q,
                                      params=lm_params_from_numpy(
                                          cfg, weights, dev))
            (state.params, state.opt_state, state.comp_state,
             m) = make_train_step(cfg, tcfg)(
                state.params, state.opt_state, state.comp_state,
                {k: v.to(dev) for k, v in batch.items()}, 0)
            state.step += 1
            out[dev] = (float(m["loss"]), state)
        (lc, sc), (lh, sh) = out["cuda"], out["cpu"]
        assert lc == pytest.approx(lh, rel=1e-5)
        sc, sh = train_state_to_numpy(sc), train_state_to_numpy(sh)
        assert sorted(sc) == sorted(sh)
        beyond = size = 0
        for k, v in sh.items():
            gap = np.abs(sc[k] - v) / (np.abs(v).max() or 1.0)
            if k.startswith("params."):
                beyond += int(np.count_nonzero(gap > 1e-4))
                size += v.size
            else:
                np.testing.assert_array_less(gap, 1e-4, err_msg=k)
        assert beyond <= 3e-5 * size, (beyond, size)

    def test_large_leaf_draw_peak(self, monkeypatch):
        from repro_torch.models import params as PM
        shape = (8, 1024, 2048)
        slice_fp32 = 4 * 1024 * 2048
        monkeypatch.setattr(PM, "DRAW_LIMIT", slice_fp32 - 1)
        schema = {"stack": PM.P(shape, ("layers", None, None),
                                fan_in_axes=(1,))}
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = PM.init_params(schema, torch.Generator(device="cuda")
                             .manual_seed(0), torch.bfloat16)
        torch.cuda.synchronize()
        leaf = out["stack"]
        assert leaf.dtype == torch.bfloat16 and leaf.shape == shape
        peak = torch.cuda.max_memory_allocated() - held
        assert peak <= 2 * leaf.numel() + slice_fp32, peak
        std = float(leaf.double().std())
        assert abs(std * 32 - 1) < 0.01        # 1 / sqrt(1024)

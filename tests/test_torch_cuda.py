"""The port's CUDA kernels against their plain PyTorch versions, on a card.

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Every test here carries the ``cuda`` marker and skips without a card (a
CUDA kernel has no CPU mode).  This file imports no JAX, so it runs on a
machine that has only PyTorch.  Tolerance rtol/atol 1e-5 at these small
widths: the same fp32 products summed in another order.
"""

import pytest
import torch

from repro_torch.kernels import ops

TOL = dict(rtol=1e-5, atol=1e-5)


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

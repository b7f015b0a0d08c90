"""The yardstick's frozen work model equals the program's at the cells'
shapes today."""

from __future__ import annotations

import pytest

from wsnbench import work
from wsnbench.tests.tiny import ROOT  # noqa: F401  (puts src on the path)

SHAPES = [
    ("fused_stream", dict(S=256, K=8, n=32, p=1024, h=128, q=32,
                          mask=False)),
    ("banded_matmul", dict(S=256, p=1024, h=128, q=32)),
    ("band_round", dict(S=1, n=256, p=1_048_576, h=128)),
    ("banded_matmul", dict(S=1, p=1_048_576, h=128, q=32)),
    ("banded_matvec", dict(S=1, p=1_048_576, h=128)),
    ("band_fold", dict(S=256, K=8, n=32, p=1024, h=128)),
]


@pytest.mark.parametrize("kernel,dims", SHAPES)
def test_kernel_work_is_the_programs(kernel, dims):
    from repro_torch.analysis import resources
    assert work.kernel_work(kernel, **dims) == resources.kernel_work(
        kernel, **dims)
    f, b = work.kernel_work(kernel, **dims)
    assert work.bound(f, b) == resources.bound(f, b)


def test_peaks_are_the_programs():
    from repro_torch.analysis import resources
    assert (work.PEAK_FP32, work.PEAK_BYTES) == (resources.PEAK_FP32,
                                                 resources.PEAK_BYTES)
    assert work.fold_flops(3, 7, 100, 9) == resources.fold_flops(3, 7, 100,
                                                                 9)

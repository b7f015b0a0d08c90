"""Pytest settings of the benchmark's tests: the marker of tests that
need a CUDA card."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA GPU with the CUDA toolkit (the port's "
        "hand-written kernels); skips with a reason elsewhere")

"""Architecture config registry: one module per assigned architecture.

A copy of ``repro.configs`` (held equal to it by
``tests/test_torch_streaming.py::TestCopiesEqualReference``), so
``get(name)`` and ``.smoke()`` give the reference's configurations.
"""

from __future__ import annotations

from repro_torch.configs.base import (ArchConfig, ShapeConfig, SHAPES,
                                applicable_shapes)

from repro_torch.configs.mamba2_2p7b import CONFIG as mamba2_2p7b
from repro_torch.configs.chameleon_34b import CONFIG as chameleon_34b
from repro_torch.configs.qwen2_7b import CONFIG as qwen2_7b
from repro_torch.configs.llama3_405b import CONFIG as llama3_405b
from repro_torch.configs.llama3p2_1b import CONFIG as llama3p2_1b
from repro_torch.configs.phi3_medium_14b import CONFIG as phi3_medium_14b
from repro_torch.configs.granite_moe_3b import CONFIG as granite_moe_3b
from repro_torch.configs.moonshot_v1_16b import CONFIG as moonshot_v1_16b
from repro_torch.configs.seamless_m4t_medium import CONFIG as seamless_m4t_medium
from repro_torch.configs.hymba_1p5b import CONFIG as hymba_1p5b
from repro_torch.configs.lm100m import CONFIG as lm100m

ARCHS: dict[str, ArchConfig] = {
    c.name: c for c in [
        mamba2_2p7b, chameleon_34b, qwen2_7b, llama3_405b, llama3p2_1b,
        phi3_medium_14b, granite_moe_3b, moonshot_v1_16b,
        seamless_m4t_medium, hymba_1p5b, lm100m,
    ]
}

ASSIGNED = [n for n in ARCHS if n != "lm100m"]

__all__ = ["ArchConfig", "ShapeConfig", "SHAPES", "ARCHS", "ASSIGNED",
           "applicable_shapes"]


def get(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[name]

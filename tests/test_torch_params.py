"""The port's parameter draw (``repro_torch.models.params.init_params``):
a leaf whose fp32 draw would pass ``DRAW_LIMIT`` (2 GiB) is drawn in
blocks of its first axis into a tensor of the target dtype; every other
leaf as one fp32 draw, scaled and cast.

* At the smoke widths of llama3.2-1b and granite-moe-3b-a800m (no leaf
  near the limit) every leaf equals, bit for bit, the one-shot draw
  written out below, in fp32 and bf16, from the same seeded generator.
* With the limit patched low, a large stacked leaf takes the block path:
  the leaves drawn before it keep their one-shot bits, it comes back in
  the target dtype, and its values keep the law: mean 0 and std
  ``scale / sqrt(fan_in)`` (the whole leaf's fan-in) within 1%, each
  block too, at one slice a block and at several.
* At full width, the leaves that take the block path are those whose
  fp32 draw passes 2 GiB (from the schemas alone, nothing drawn).
"""

import math

import pytest
import torch

from repro_torch import configs
from repro_torch.models import params as PM
from repro_torch.models import transformer as T
from repro_torch.models.params import P, init_params, tree_leaves


def one_shot(schema: dict, seed: int, dtype: torch.dtype) -> dict:
    """Every leaf in sorted path order: zeros, ones, or one fp32 normal
    draw times scale / sqrt(fan_in), cast to ``dtype``."""
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for path, leaf in tree_leaves(schema):
        if leaf.init == "zeros":
            out[path] = torch.zeros(leaf.shape, dtype=dtype)
        elif leaf.init == "ones":
            out[path] = torch.ones(leaf.shape, dtype=dtype)
        else:
            fan_in = math.prod(leaf.shape[a] for a in leaf.fan_in_axes)
            std = leaf.scale / math.sqrt(max(fan_in, 1))
            out[path] = (torch.randn(leaf.shape, generator=gen,
                                     dtype=torch.float32) * std).to(dtype)
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("arch", ["llama3.2-1b", "granite-moe-3b-a800m"])
def test_small_leaves_draw_as_one_shot(arch, dtype):
    schema = T.model_schema(configs.get(arch).smoke())
    got = dict(tree_leaves(init_params(
        schema, torch.Generator().manual_seed(3), dtype, device="cpu")))
    want = one_shot(schema, 3, dtype)
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        assert got[path].dtype == dtype and torch.equal(got[path], w), path


# two small leaves drawn ahead of a stack of 6 layers of (96, 160)
SCHEMA = {
    "a_first": P((40, 24), (None, None), fan_in_axes=(0,)),
    "b_norm": P((24,), (None,), init="ones"),
    "c_stack": P((6, 96, 160), ("layers", None, None), fan_in_axes=(1,),
                 scale=0.5),
}
SLICE = 4 * 96 * 160                 # one layer's fp32 bytes


@pytest.mark.parametrize("limit,per", [(SLICE - 1, 1), (SLICE, 1),
                                       (2 * SLICE + 7, 2), (4 * SLICE, 4)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_large_leaf_drawn_in_blocks_keeps_the_law(monkeypatch, limit, per,
                                                  dtype):
    monkeypatch.setattr(PM, "DRAW_LIMIT", limit)
    draws = []
    real = torch.randn

    def counted(shape, *a, **kw):
        draws.append(tuple(shape))
        return real(shape, *a, **kw)

    monkeypatch.setattr(torch, "randn", counted)
    got = init_params(SCHEMA, torch.Generator().manual_seed(5), dtype,
                      device="cpu")
    monkeypatch.setattr(torch, "randn", real)
    want = one_shot(SCHEMA, 5, dtype)
    assert torch.equal(got["a_first"], want["a_first"])
    assert torch.equal(got["b_norm"], want["b_norm"])
    stack = got["c_stack"]
    assert stack.dtype == dtype and stack.shape == (6, 96, 160)
    # the block path's draws: ceil(6 / per) blocks of `per` layers
    assert draws[1:] == [(min(per, 6 - i), 96, 160)
                         for i in range(0, 6, per)]
    std = 0.5 / math.sqrt(96)
    w = stack.double()
    assert abs(w.std().item() / std - 1) < 0.01
    assert abs(w.mean().item()) < 0.01 * std
    for i in range(0, 6, per):
        assert abs(w[i:i + per].std().item() / std - 1) < 0.03, i


def test_full_width_leaves_past_the_limit():
    """Which leaves of the shipped one-card configurations take the block
    path (schemas only)."""
    def past(name):
        return sorted(path for path, leaf in
                      tree_leaves(T.model_schema(configs.get(name)))
                      if leaf.init == "normal"
                      and 4 * math.prod(leaf.shape) > PM.DRAW_LIMIT)

    assert PM.DRAW_LIMIT == 2 * 2 ** 30
    assert past("llama3.2-1b") == past("hymba-1.5b") == \
        past("seamless-m4t-medium") == past("lm100m") == []
    mlp = ["layers.mlp.w_down", "layers.mlp.w_gate", "layers.mlp.w_up"]
    moe = ["layers.moe.w_down", "layers.moe.w_gate", "layers.moe.w_up"]
    assert past("granite-moe-3b-a800m") == moe
    assert past("moonshot-v1-16b-a3b") == moe
    assert past("qwen2-7b") == ["embed"] + mlp + ["out_head"]
    assert past("phi3-medium-14b") == ["layers.attn.wo",
                                       "layers.attn.wq"] + mlp
    assert past("chameleon-34b") == ["layers.attn.wo",
                                     "layers.attn.wq"] + mlp
    assert past("mamba2-2.7b") == ["layers.ssm.in_proj",
                                   "layers.ssm.out_proj"]

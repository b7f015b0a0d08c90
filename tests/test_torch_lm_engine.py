"""The port's LM ``Engine`` (``repro_torch.serve.engine``) against the JAX
reference's, on the CPU.

``repro.serve.engine`` needs the names jax 0.9 moved out of ``jax.core``,
so the reference engine runs once in a child process
(``tests/torch_ref_child.py lm_engine``): at the ``.smoke()`` widths of
llama3.2-1b (dense, 3 slots, a 32-slot cache, eight prompts of 2 to 27
tokens over the 8/16/32 buckets, the longest running into the cache's
end), granite-moe-3b-a800m (MoE), mamba2-2.7b (SSM, a one-token prompt
among them) and hymba-1.5b (hybrid: 8 meta tokens ahead of each prompt,
a 16-position window on layer 1), the last three at exact prompt
lengths, from the reference's ``init_params(cfg, PRNGKey(0))``, with
random ``max_new_tokens`` and an ``eos_id`` on every third request.  The
port's engine serves the same requests from the same weights, and every
request's tokens must be equal: greedy tokens are integers, and the
smoke widths leave the arg-max far from a tie (the logits agree to 1e-4,
tests/test_torch_lm.py and tests/test_torch_lm_families.py).  A slot's
prefill overwrites its SSM state and conv history whole, so what an
earlier request left there never reaches the next one.

The reference's own engine tests (tests/test_train.py::TestServing) are
ported on the port alone: continuous batching, the engine == a direct
prefill + decode loop, and the bucketed prefill's first token == the
exact-length prefill's (logits rtol/atol 1e-5: the same weights and
tokens, only the pad suffix differs).
"""

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.convert import lm_params_from_numpy
from repro_torch.examples import serve_lm
from repro_torch.models import transformer as T
from repro_torch.serve.engine import Engine, Request, ServeConfig

from torch_parity import run_reference

SCENARIOS = ("dense", "moe", "ssm", "hybrid")


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return run_reference("lm_engine",
                         tmp_path_factory.mktemp("ref") / "lm.npz")


def _setup(ref, name):
    cfg = configs.get(str(ref[f"{name}/arch"])).smoke()
    pre = f"{name}/params."
    params = lm_params_from_numpy(
        cfg, {k[len(pre):]: v for k, v in ref.items() if k.startswith(pre)},
        device="cpu")
    scfg = ServeConfig(slots=int(ref[f"{name}/slots"]),
                       max_len=int(ref[f"{name}/max_len"]))
    reqs = []
    i = 0
    while f"{name}/req{i}/prompt" in ref:
        reqs.append(Request(prompt=ref[f"{name}/req{i}/prompt"],
                            max_new_tokens=int(ref[f"{name}/req{i}/max_new"]),
                            eos_id=int(ref[f"{name}/req{i}/eos"])))
        i += 1
    return cfg, params, scfg, reqs


@pytest.mark.parametrize("name", SCENARIOS)
def test_engine_tokens_equal_reference(ref, name):
    cfg, params, scfg, reqs = _setup(ref, name)
    eng = Engine(cfg, params, scfg, device="cpu")
    for r in reqs:
        eng.submit(r)
    eng.run_until_done()
    for i, r in enumerate(reqs):
        assert r.done
        assert r.output == ref[f"{name}/req{i}/output"].tolist(), i
    # the longest dense prompt stopped at the cache's end, not its budget
    if name == "dense":
        last = reqs[-1]
        assert len(last.prompt) + len(last.output) - 1 == scfg.max_len - 1
        assert len(last.output) < last.max_new_tokens


def test_bucket_lengths():
    cfg = configs.get("llama3.2-1b").smoke()
    params = T.init_params(cfg, 0, device="cpu")
    eng = Engine(cfg, params, ServeConfig(slots=1, max_len=32), device="cpu")
    assert [eng._bucket_len(s) for s in (2, 3, 5, 7, 8, 9, 12, 17, 31)] == \
        [8, 8, 8, 8, 8, 16, 16, 32, 32]
    for name in ("granite-moe-3b-a800m", "mamba2-2.7b", "hymba-1.5b"):
        other = configs.get(name).smoke()
        eng = Engine(other, T.init_params(other, 0, device="cpu"),
                     ServeConfig(slots=1, max_len=32), device="cpu")
        assert [eng._bucket_len(s) for s in (2, 9, 17)] == [2, 9, 17]


@pytest.mark.parametrize("name", SCENARIOS)
def test_engine_continuous_batching(ref, name):
    cfg, params, _, _ = _setup(ref, name)
    eng = Engine(cfg, params, ServeConfig(slots=2, max_len=32), device="cpu")
    rng = np.random.default_rng(0)
    reqs = [Request(prompt=rng.integers(0, cfg.vocab_size, 4)
                    .astype(np.int32), max_new_tokens=4) for _ in range(5)]
    for r in reqs:
        eng.submit(r)
    eng.run_until_done()
    for r in reqs:
        assert r.done and len(r.output) == 4
        assert all(0 <= t < cfg.vocab_size for t in r.output)


@pytest.mark.parametrize("name", SCENARIOS)
def test_engine_matches_direct_decode(ref, name):
    """A one-slot engine's tokens == a direct prefill + decode_step loop."""
    cfg, params, _, _ = _setup(ref, name)
    prompt = np.arange(4, dtype=np.int32) + 7
    eng = Engine(cfg, params, ServeConfig(slots=1, max_len=32), device="cpu")
    req = Request(prompt=prompt, max_new_tokens=5)
    eng.submit(req)
    eng.run_until_done()

    state = T.init_decode_state(cfg, 1, 32, dtype=torch.float32,
                                device="cpu")
    logits, state = T.prefill(params, cfg, torch.tensor(prompt[None]), state)
    toks = [int(torch.argmax(logits, -1)[0])]
    for t in range(len(prompt), len(prompt) + 4):
        lg, state = T.decode_step(params, cfg, torch.tensor([[toks[-1]]]),
                                  state, t)
        toks.append(int(torch.argmax(lg, -1)[0]))
    assert req.output == toks


def test_prefill_buckets_identical_first_token(ref):
    cfg, params, _, _ = _setup(ref, "dense")
    eng = Engine(cfg, params, ServeConfig(slots=1, max_len=32), device="cpu")
    rng = np.random.default_rng(3)
    for s_len in (2, 3, 5, 7, 9, 12):
        prompt = rng.integers(0, cfg.vocab_size, s_len).astype(np.int32)
        req = Request(prompt=prompt, max_new_tokens=1)
        eng.submit(req)
        eng.run_until_done()
        state = T.init_decode_state(cfg, 1, 32, dtype=torch.float32,
                                    device="cpu")
        logits, _ = T.prefill(params, cfg, torch.tensor(prompt[None]), state)
        assert req.output[0] == int(torch.argmax(logits, -1)[0]), s_len
        padded = np.zeros(eng._bucket_len(s_len), np.int32)
        padded[:s_len] = prompt
        state = T.init_decode_state(cfg, 1, 32, dtype=torch.float32,
                                    device="cpu")
        bucketed, _ = T.prefill(params, cfg, torch.tensor(padded[None]),
                                state, valid_len=s_len)
        torch.testing.assert_close(bucketed, logits, rtol=1e-5, atol=1e-5)


def test_eos_stops_a_request(ref):
    """A request whose eos_id is the token it would emit third stops
    there; its slot is refilled from the queue."""
    cfg, params, _, _ = _setup(ref, "dense")
    prompt = np.arange(5, dtype=np.int32) + 3

    def serve(eos):
        eng = Engine(cfg, params, ServeConfig(slots=1, max_len=32),
                     device="cpu")
        reqs = [Request(prompt=prompt, max_new_tokens=6, eos_id=eos),
                Request(prompt=prompt[:3], max_new_tokens=2)]
        for r in reqs:
            eng.submit(r)
        eng.run_until_done()
        return reqs

    free = serve(-1)[0].output
    stopped, nxt = serve(free[2])
    assert stopped.done and stopped.output == free[:free.index(free[2]) + 1]
    assert nxt.done and len(nxt.output) == 2


def test_engine_device_checks():
    cfg = configs.get("llama3.2-1b").smoke()
    params = T.init_params(cfg, 0, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            Engine(cfg, params, ServeConfig())
    with pytest.raises(ValueError, match="lie on"):
        Engine(cfg, params, ServeConfig(), device="meta")


def test_serve_lm_example_on_cpu(capsys):
    serve_lm.main(["--device", "cpu", "--requests", "5", "--slots", "2",
                   "--max-new", "4"])
    out = capsys.readouterr().out
    assert "5 requests, 20 tokens" in out and "on CPU" in out

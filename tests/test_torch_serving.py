"""Twins of the JAX package's serving tests for the port: the
continuous-batching ``ServingEngine`` (``tests/test_substrates.py``'s
``TestServing``), a token-for-token comparison of the two engines on the
same converted weights, the tracer's span and counter names, the nested
``convert`` round trip, and the serve launcher on the CPU.

The engines are compared greedy only: above temperature 0 the port draws
with ``torch.multinomial`` and JAX with ``jax.random.categorical``, which
give other bits from one seed.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.nn.layers as JL
import repro_torch.nn.layers as TL
from repro import obs as jobs
from repro.configs.base import get_config as jget_config
from repro.nn.model import LM as JLM
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JServingEngine
from repro_torch import convert, obs
from repro_torch.configs import get_config
from repro_torch.launch import serve
from repro_torch.nn.model import LM
from repro_torch.serving import Request, ServingEngine


def yi(seed=0):
    lm = LM(get_config("yi_6b", reduced=True), device="cpu")
    return lm, lm.init(torch.Generator().manual_seed(seed))


def test_continuous_batching_completes_all():
    lm, params = yi()
    eng = ServingEngine(lm, params, max_len=32, batch_slots=2)
    for uid in range(4):
        eng.submit(Request(uid, np.arange(1 + uid, dtype=np.int32) + 1,
                           max_new_tokens=3 + uid))
    done = eng.run_to_completion()
    assert sorted(r.uid for r in done) == [0, 1, 2, 3]
    assert all(len(r.generated) >= r.max_new_tokens for r in done)
    assert all(r.done for r in done)


def test_greedy_serving_matches_prefill():
    lm, params = yi()
    prompt = np.array([3, 1, 4, 1, 5], np.int32)
    logits, _ = lm.prefill(params, {"tokens": torch.from_numpy(prompt)[None]})
    expect = int(torch.argmax(logits[0, 0]))
    eng = ServingEngine(lm, params, max_len=16, batch_slots=1)
    eng.submit(Request(0, prompt, max_new_tokens=1))
    done = eng.run_to_completion()
    assert done[0].generated[0] == expect


def requests(cls, vocab):
    rng = np.random.RandomState(3)
    return [cls(uid, rng.randint(0, vocab, 2 + 2 * uid).astype(np.int32),
                max_new_tokens=3 + uid) for uid in range(4)]


def run_both(monkeypatch, tracers=(None, None)):
    """The JAX and the port engine, float32 compute, reduced yi_6b with the
    JAX init's weights, 2 slots, 4 requests; returns both finished lists."""
    monkeypatch.setattr(JL, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(TL, "COMPUTE_DTYPE", torch.float32)
    jlm = JLM(jget_config("yi_6b", reduced=True))
    jp = jax.jit(jlm.init)(jax.random.PRNGKey(0))
    lm = LM(get_config("yi_6b", reduced=True), device="cpu")
    out = []
    for eng, req in [
            (JServingEngine(jlm, jp, max_len=32, batch_slots=2), JRequest),
            (ServingEngine(lm, convert.from_jax_params(jp, device="cpu"),
                           max_len=32, batch_slots=2), Request)]:
        eng.tracer = tracers[len(out)]
        for r in requests(req, lm.cfg.vocab):
            eng.submit(r)
        out.append(eng.run_to_completion())
    return out


def test_engine_emits_the_jax_engines_tokens(monkeypatch):
    jdone, tdone = run_both(monkeypatch)
    assert [r.uid for r in tdone] == [r.uid for r in jdone]
    for j, t in zip(jdone, tdone):
        assert t.generated == [int(x) for x in j.generated], t.uid


def test_tracer_names_are_the_jax_engines(monkeypatch):
    jtr, ttr = jobs.Tracer(), obs.Tracer()
    run_both(monkeypatch, (jtr, ttr))
    names = {s.name for s in ttr.spans}
    assert names == {s.name for s in jtr.spans} == {"serve.prefill",
                                                    "serve.step"}
    assert ttr.counters == jtr.counters
    assert set(ttr.counters) == {"serve.admitted", "serve.prefill_tokens",
                                 "serve.decode_tokens"}
    assert ttr.counters["serve.admitted"] == 4
    assert set(ttr.histograms) == set(jtr.histograms) == {"serve.step_ms"}
    assert len(ttr.points) == len(jtr.points)
    assert sorted(s.attrs.get("uid") for s in ttr.spans
                  if s.name == "serve.prefill") == [0, 1, 2, 3]


def test_sampling_above_zero_temperature_is_seeded():
    lm, params = yi()

    def run(seed):
        eng = ServingEngine(lm, params, max_len=16, batch_slots=2,
                            temperature=1.0, seed=seed)
        for r in requests(Request, lm.cfg.vocab)[:2]:
            eng.submit(r)
        return [r.generated for r in eng.run_to_completion()]

    assert run(5) == run(5)
    assert all(0 <= t < lm.cfg.vocab for g in run(6) for t in g)


def test_convert_nested_round_trip():
    """A JAX LM.init tree (stacked layers, bf16 matrices beside float32
    norms) comes back equal, each leaf in its own type."""
    cfg = dataclasses.replace(jget_config("yi_6b", reduced=True),
                              param_dtype="bfloat16")
    jp = jax.jit(JLM(cfg).init)(jax.random.PRNGKey(0))
    tp = convert.from_jax_params(jp, device="cpu")
    assert tp["layers"]["attn"]["wq"].dtype == torch.bfloat16
    assert tp["final_norm"]["w"].dtype == torch.float32
    assert tp["layers"]["attn"]["wq"].shape == jp["layers"]["attn"]["wq"].shape
    back = convert.to_numpy(tp)
    flat_j = jax.tree_util.tree_flatten_with_path(jp)[0]
    flat_t = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_j) == len(flat_t)
    for path, leaf in flat_j:
        np.testing.assert_array_equal(flat_t[path],
                                      np.asarray(leaf, np.float32))


def test_serve_launcher_on_the_cpu(capsys):
    done = serve.main(["--arch", "yi_6b", "--reduced", "--device", "cpu",
                       "--requests", "3", "--slots", "2", "--max-new", "4"])
    assert sorted(r.uid for r in done) == [0, 1, 2]
    assert "3 requests" in capsys.readouterr().out


def test_serve_launcher_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--arch", "yi_6b", "--reduced"])

"""Twins of the repository's examples (``examples/*.py``, the JAX
package's scripts) for the port's ``repro_torch.examples``: each example
runs on the CPU through its ``main`` or the function that takes its
weights, beside the JAX package's own functions on the same inputs.

Tolerances: the paper engines' weights at ``tests/test_torch_system.py``'s
Iris bound (rtol 1e-4, atol 1e-5: float32 on both sides, sums in another
order); the in-database runs and the zoo at ``tests/test_db_backend.py``'s
and ``tests/test_zoo_db.py``'s ``TOL = 1e-4`` (the database sums in
float64, the engines in float32); the LM examples in float32 compute
(monkeypatched, here only), the served tokens equal, the training losses
at ``tests/test_torch_train.py``'s step tolerance (rtol 2e-4, atol 2e-5).
The LM weights are the JAX init's, carried across by
``convert.from_jax_params``: the two packages draw other numbers from one
seed.
"""
import argparse
import collections
import importlib
import importlib.util
import os
import tempfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.nn.layers as JL
import repro_torch.nn.layers as TL
from repro import data as jdata
from repro import obs as jobs
from repro.configs.base import ArchConfig as JArchConfig
from repro.configs.base import get_config as jget_config
from repro.core import Engine as JEngine
from repro.core import nn2sql as jnn
from repro.core import sqlgen as jsqlgen
from repro.core.relational import one_hot_dense as j_one_hot_dense
from repro.db import zoo as jzoo
from repro.db.adapter import connect as jconnect
from repro.db.plan_cache import PlanCache as JPlanCache
from repro.db.sql_engine import SQLEngine as JSQLEngine
from repro.db.train import infer_in_db as j_infer_in_db
from repro.db.train import train_in_db as j_train_in_db
from repro.nn.model import LM as JLM
from repro.optim import adamw as jadamw
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JServingEngine
from repro.train import Trainer as JTrainer
from repro_torch import convert
from repro_torch.examples import (mnist_e2e, observe_in_db, quickstart,
                                  serve_lm, train_in_db, train_lm, zoo_in_db)
from repro_torch.nn.model import LM
from repro_torch.obs import report

ROOT = Path(__file__).resolve().parents[1]
CPU = ["--device", "cpu"]
KINDS = ("dense", "relational")
IRIS_TOL = dict(rtol=1e-4, atol=1e-5)
TOL = 1e-4
STEP = dict(rtol=2e-4, atol=2e-5)
EXAMPLES = ("quickstart", "mnist_e2e", "train_in_db", "observe_in_db",
            "zoo_in_db", "serve_lm", "train_lm")


def reference_script(name: str):
    """The JAX package's example ``examples/<name>.py`` as a module (its
    ``main`` is not run)."""
    spec = importlib.util.spec_from_file_location(
        f"reference_example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def f32_compute(monkeypatch):
    monkeypatch.setattr(JL, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(TL, "COMPUTE_DTYPE", torch.float32)


def jax_train(graph, w0, x, y, y_oh, iters):
    """The JAX package's training and inference on both engines: each
    engine's final weights and accuracy."""
    out = {}
    for kind in KINDS:
        eng = JEngine(kind)
        wf, _ = jnn.train(graph, w0, x, y_oh, iters, eng)
        probs = jnn.infer(graph, eng)(wf, x)
        out[kind] = dict(weights=wf, accuracy=float(jnn.accuracy(probs, y)))
    return out


def assert_runs_match(runs, jruns, tol):
    for kind in KINDS:
        for name, w in jruns[kind]["weights"].items():
            np.testing.assert_allclose(runs[kind]["weights"][name].numpy(),
                                       np.asarray(w), err_msg=f"{kind} {name}",
                                       **tol)
        assert runs[kind]["accuracy"] == jruns[kind]["accuracy"], kind


def test_quickstart_matches_the_reference(monkeypatch, capsys):
    """Iris on both engines, the weights, the accuracies and the two
    rendered training queries, string for string.  ITERS is cut to 8: at
    lr 0.05 the first dozen iterations about double the rounding error
    each, in both packages (each float32 run 2e-6 from float64 training
    at 8 iterations, 3e-5 at 10, 4e-4 at 20, the JAX package's the
    farther), so past 10 the packages' float32 runs part by more than
    the float32 bound says nothing about."""
    monkeypatch.setattr(quickstart, "ITERS", 8)
    out = quickstart.main(CPU)
    jx, jy = jdata.make_iris()
    spec = jnn.MLPSpec(n_rows=150, n_features=4, n_hidden=quickstart.HIDDEN,
                       n_classes=3, lr=0.05)
    graph = jnn.build_graph(spec)
    jruns = jax_train(graph, jnn.init_weights(spec), jx, jy,
                      j_one_hot_dense(jy, 3).to_dense(), 8)
    assert_runs_match(out["runs"], jruns, IRIS_TOL)
    assert out["sql92"] == jsqlgen.training_query_sql92(graph, 8, spec.lr)
    assert out["arrays"] == jsqlgen.training_query_arrays(graph, 8, spec.lr)
    text = capsys.readouterr().out
    assert "8 iterations in" in text and "Listing 10" in text


def test_mnist_e2e_matches_the_reference(capsys):
    out = mnist_e2e.main(["--batch", "64", "--hidden", "8", "--epochs", "3"]
                         + CPU)
    jx, jy = jdata.make_mnist_like(64)
    spec = jnn.MLPSpec(64, 784, 8, 10, lr=0.1)
    jruns = jax_train(jnn.build_graph(spec), jnn.init_weights(spec), jx, jy,
                      jnp.asarray(jdata.one_hot_labels(jy, 10)), 3)
    assert_runs_match(out["runs"], jruns, IRIS_TOL)
    for kind in KINDS:
        assert out["runs"][kind]["probs"].shape == (64, 10)
    assert capsys.readouterr().out.count("tuples/s") == 4


def test_train_in_db_matches_the_reference(monkeypatch):
    """Three iterations in sqlite: the in-database weights and
    probabilities against the JAX package's in-database run and against
    the port's dense engine, and the rendered training SQL."""
    monkeypatch.setattr(train_in_db, "N_ITERS", 3)
    out = train_in_db.main(CPU)
    ref = reference_script("train_in_db")
    graph = jnn.build_graph(ref.spec)
    weights = {k: np.asarray(v)
               for k, v in jnn.init_weights(ref.spec).items()}
    x, y, labels = ref.iris_like(ref.spec)
    jres = j_train_in_db(graph, weights, x, y, 3, backend="sqlite")
    res = out["result"]
    assert out["backend"] == "sqlite" and res.n_iters == jres.n_iters == 3
    assert res.sql == jres.sql and res.strategy == jres.strategy
    for k, w in jres.weights.items():
        np.testing.assert_allclose(res.weights[k], w, atol=TOL)
        np.testing.assert_allclose(out["weights_dense"][k].numpy(),
                                   res.weights[k], atol=TOL)
    np.testing.assert_allclose(
        out["probs_db"], j_infer_in_db(graph, jres.weights, x), atol=TOL)
    np.testing.assert_allclose(out["probs_dense"].numpy(), out["probs_db"],
                               atol=TOL)
    assert out["max_diff_weights"] <= TOL and out["max_diff_probs"] <= TOL
    assert len(out["trajectory"]) == 4 and np.isfinite(out["trajectory"]).all()
    assert {"hits", "misses", "entries"} <= set(out["plan_cache"])


def jax_observe(tmp_path):
    """``examples/observe_in_db.py``'s calls on the JAX package, its trace
    written under ``tmp_path``."""
    ref = reference_script("observe_in_db")
    graph = jnn.build_graph(ref.spec)
    weights = {k: np.asarray(v)
               for k, v in jnn.init_weights(ref.spec).items()}
    x, y = ref.iris_like(ref.spec)
    tracer = jobs.Tracer()
    adapter = jconnect("sqlite")
    cache = JPlanCache(path=None)
    with jobs.use(tracer):
        j_train_in_db(graph, weights, x, y, n_iters=10, adapter=adapter,
                      plan_cache_=cache)
    eng = JSQLEngine(adapter=adapter, plan_cache_=cache, tracer=tracer)
    env = {**weights, "img": x, "one_hot": y}
    eng.evaluate([graph.loss], env)
    eng.evaluate([graph.loss], env)
    n_spans = jobs.write_trace_spans(adapter, tracer)
    stages = adapter.execute(jobs.STAGE_SQL)
    bd = jobs.stage_breakdown(tracer, root="train.in_db")
    stats = eng.stats
    res = eng.profile_value_and_grad(graph.loss, [graph.w_xh, graph.w_ho],
                                     env)
    jobs.write_profile_nodes(adapter, res)
    nodes = adapter.execute(jobs.NODE_SQL)[:5]
    jobs.write_metric_points(adapter, tracer)
    metrics = adapter.execute(jobs.METRIC_SQL)
    jobs.write_chrome_trace(tracer, str(tmp_path / "jax.trace.json"))
    eng.close()
    return dict(tracer=tracer, spans=n_spans, stage_rows=stages,
                breakdown=bd, stats=stats, profile=res, node_rows=nodes,
                metric_rows=metrics)


def test_observe_in_db_matches_the_reference(monkeypatch, tmp_path):
    """The span names (with their counts) and the rows written of them,
    the stage names, the plan cache's hits and misses, the profiled node
    kinds and the metric names equal the JAX package's run of the same
    calls; the trace file lands in the working directory and loads
    through ``obs.report``."""
    monkeypatch.chdir(tmp_path)
    out = observe_in_db.main(CPU)
    want = jax_observe(tmp_path)
    names = lambda t: collections.Counter(s.name for s in t.spans)
    assert names(out["tracer"]) == names(want["tracer"])
    # the SQL reads and the breakdown order by time: compare the names
    first = lambda rows: sorted(r[0] for r in rows)
    assert first(out["stage_rows"]) == first(want["stage_rows"])
    assert sorted(out["breakdown"]["stages"]) == sorted(
        want["breakdown"]["stages"])
    for key in ("cache_hits", "cache_misses", "cache_evictions", "queries"):
        assert out["stats"][key] == want["stats"][key], key
    kinds = lambda res: collections.Counter(n.kind for n in res.nodes)
    assert kinds(out["profile"]) == kinds(want["profile"])
    assert len(out["node_rows"]) == len(want["node_rows"])
    assert first(out["metric_rows"]) == first(want["metric_rows"])
    path = tmp_path / observe_in_db.TRACE_PATH
    assert Path(out["trace_path"]).resolve() == path.resolve()
    capture = report.load_capture(str(path))
    assert report.render(capture, top=5) == out["report"]
    assert out["spans"] == want["spans"]


def test_zoo_in_db_matches_the_reference(capsys):
    """Every printed difference within ``TOL``; the gradient tables and
    ``max|∂router|`` as the JAX package's in-database run gives them."""
    out = zoo_in_db.main(CPU)
    for key in ("moe", "rwkv_o", "rwkv_s", "channel_mix"):
        assert out[key] <= TOL, key
    rng = np.random.RandomState(0)
    cfg = jzoo.MoESQLConfig(n_tokens=16, d_model=8, n_experts=4, top_k=2,
                            d_ff=16)
    params = jzoo.init_moe_params(cfg)
    x = rng.randn(cfg.n_tokens, cfg.d_model).astype(np.float32)
    graph = jzoo.moe_ffn_graph(cfg)
    eng = JSQLEngine(backend="sqlite")
    vg = eng.value_and_grad_fn(graph.out, list(graph.weight_vars))
    loss, grads = vg(jzoo.moe_env(cfg, params, x))
    eng.close()
    assert out["grad_tables"] == len(grads)
    assert abs(out["router_max"] - float(np.abs(grads["w_router"]).max())) \
        <= TOL
    np.testing.assert_allclose(out["loss"], loss, atol=TOL)
    for name, g in grads.items():
        np.testing.assert_allclose(out["grads"][name], g, atol=TOL,
                                   err_msg=name)
    assert "RWKV-6 time mix (S=12, N=4)" in capsys.readouterr().out


def test_serve_lm_emits_the_jax_engines_tokens(f32_compute):
    """The reduced Yi-6B with the JAX init's weights, greedy: every
    request's generated tokens equal those of the JAX package's
    ``ServingEngine`` fed the same requests."""
    n, slots, max_new, max_len = 5, 2, 6, 64
    jlm = JLM(jget_config("yi_6b", reduced=True))
    jp = jax.jit(jlm.init)(jax.random.PRNGKey(0))
    lm = LM(serve_lm.get_config("yi_6b", reduced=True), device="cpu")
    out = serve_lm.serve(lm, convert.from_jax_params(jp, device="cpu"), n,
                         slots, max_new, max_len, 0.0)
    jeng = JServingEngine(jlm, jp, max_len=max_len, batch_slots=slots)
    rng = np.random.RandomState(0)
    for uid in range(n):
        plen = int(rng.randint(2, 10))
        jeng.submit(JRequest(uid, rng.randint(0, lm.cfg.vocab, plen)
                             .astype(np.int32), max_new_tokens=max_new))
    jdone = sorted(jeng.run_to_completion(), key=lambda r: r.uid)
    assert [r.uid for r in out["done"]] == [r.uid for r in jdone]
    for j, t in zip(jdone, out["done"]):
        np.testing.assert_array_equal(t.prompt, j.prompt)
        assert t.generated == [int(x) for x in j.generated], t.uid


def test_serve_lm_main_serves_every_request(capsys):
    out = serve_lm.main(["--requests", "3", "--slots", "2", "--max-new", "4"]
                        + CPU)
    assert out["requests"] == 3 and out["tokens"] == 12
    assert all(len(g) == 4 for g in out["generated"].values())
    assert "served 3 requests / 12 tokens" in capsys.readouterr().out


class JaxBatches:
    def __init__(self, batch):
        self.batch = {k: jnp.asarray(v) for k, v in batch.items()}

    def batch_at(self, step):
        return self.batch


class TorchBatches:
    def __init__(self, batch):
        self.batch = {k: torch.from_numpy(v) for k, v in batch.items()}

    def batch_at(self, step):
        return self.batch


def test_train_lm_presets_are_the_references():
    ref = reference_script("train_lm")
    assert train_lm.PRESETS == ref.PRESETS
    for preset, kw in ref.PRESETS.items():
        jcfg = JArchConfig(name=f"lm-{preset}", family="dense", **kw)
        assert train_lm.config(preset, None).n_params == jcfg.n_params
    assert train_lm.config("tiny", "dbrx_132b").n_params == \
        jget_config("dbrx_132b", reduced=True).n_params


def test_train_lm_losses_match_jax(f32_compute):
    """The tiny preset from the JAX init's weights, three AdamW steps on
    one numpy batch in both packages: each step's loss and grad norm."""
    cfg = train_lm.config("tiny", None)
    jlm = JLM(JArchConfig(name="lm-tiny", family="dense",
                          **train_lm.PRESETS["tiny"]))
    jp = jax.jit(jlm.init)(jax.random.PRNGKey(0))
    rng = np.random.RandomState(0)
    toks = rng.randint(0, cfg.vocab, (4, 17)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    trainer = train_lm.make_trainer(cfg, TorchBatches(batch), 3e-4, 1, None,
                                    "cpu")
    params = convert.from_jax_params(jp, device="cpu")
    trainer.init_state = lambda _gen: (params,
                                       trainer.optimizer.init(params))
    out = train_lm.train(trainer, 3)
    jout = JTrainer(jlm, jadamw(3e-4), JaxBatches(batch)).run(
        jax.random.PRNGKey(0), 3, log_every=0)
    assert len(out["history"]) == len(jout["history"]) == 3
    for h, j in zip(out["history"], jout["history"]):
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(h[key], j[key], err_msg=key, **STEP)
    assert out["checkpoints"] == []


def test_train_lm_main_checkpoints(tmp_path, capsys):
    """``main`` on the token stream, the checkpoint written at the end into
    ``--ckpt-dir``; the run's numbers are what it prints."""
    out = train_lm.main(["--steps", "2", "--seq", "16", "--batch", "2",
                         "--ckpt-dir", str(tmp_path)] + CPU)
    assert out["checkpoints"] == [2] and len(out["history"]) == 2
    assert out["tokens_per_step"] == 32 and out["arch"] == "lm-tiny"
    text = capsys.readouterr().out
    assert f"params≈{out['params'] / 1e6:.1f}M" in text
    assert f"loss {out['history'][0]['loss']:.4f} →" in text


@pytest.mark.parametrize("name", EXAMPLES)
def test_examples_default_to_the_card(name):
    """Without ``--device`` every example asks for the card, and raises
    where there is none, as the launchers do; it never runs on the
    CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    mod = importlib.import_module(f"repro_torch.examples.{name}")
    with pytest.raises(RuntimeError, match="CUDA"):
        mod.main([])


def test_train_lm_does_not_share_the_references_checkpoints(monkeypatch):
    """The reference script resumes from ``/tmp/repro_lm_ckpt``; a JAX
    checkpoint is not the port's format, so the port's default differs:
    a directory a model in the process's own temporary directory."""
    defaults = []

    def stop(self, args=None, namespace=None):
        defaults.append(self.get_default("ckpt_dir"))
        raise SystemExit

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", stop)
    for main in (train_lm.main, reference_script("train_lm").main):
        with pytest.raises(SystemExit):
            main()
    assert defaults == [None, "/tmp/repro_lm_ckpt"]
    assert train_lm.default_ckpt_dir(train_lm.config("tiny", None)) == \
        os.path.join(tempfile.gettempdir(), "repro_torch_lm_ckpt", "lm-tiny")


def test_train_lm_default_checkpoints_resume_per_model(tmp_path, monkeypatch,
                                                       capsys):
    """Without ``--ckpt-dir``: a second run of the same command resumes at
    its last step and trains none, and another preset starts afresh in its
    own directory rather than restoring the first one's shapes."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    argv = ["--steps", "1", "--seq", "8", "--batch", "2"] + CPU
    first = train_lm.main(argv)
    again = train_lm.main(argv)
    other = train_lm.main(argv + ["--preset", "20m"])
    assert first["ckpt_dir"] == again["ckpt_dir"] == \
        str(tmp_path / "repro_torch_lm_ckpt" / "lm-tiny")
    assert other["ckpt_dir"] == str(tmp_path / "repro_torch_lm_ckpt" /
                                    "lm-20m")
    assert len(first["history"]) == len(other["history"]) == 1
    assert again["history"] == [] and again["checkpoints"] == [1]
    assert "no step trained" in capsys.readouterr().out

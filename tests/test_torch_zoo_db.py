"""The port's DAG zoo in SQL (``repro_torch.db.zoo``) against the JAX
package's: the flows of ``tests/test_zoo_db.py`` and
``tests/test_ssm_db.py``, forward and Algorithm-1 backward, in both
representations, plus what ``tests/test_zoo_{primitives,edge_regressions,
property}.py`` check that ``tests/test_torch_engines.py`` and
``tests/test_torch_db.py`` do not: the zoo's gradient DAGs executed in the
database, ArgTopK's boundary ties, Scatter's colliding indices, 0-row
relations, Softmax at ±750, non-finite scan states, and Gather/Scatter
adjointness in sqlite.

Tolerance ``TOL = 1e-4``, the reference tests' own bound (the database
sums in float64; the oracles run in float32).  Card counterparts
(``ops.*`` on the CPU here are the kernels' plain versions; the kernels
themselves are held in ``tests/test_torch_cuda.py`` and ``chip_smoke.py``
phase 10).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import Engine as JEngine
from repro.core import expr as JE
from repro.core.autodiff import derive as jderive
from repro.core.autodiff import gradients as jgradients
from repro.db import zoo as jzoo
from repro.db.sql_engine import SQLEngine as JSQLEngine
from repro.kernels import ref as jref
from repro_torch.core import Engine, dense
from repro_torch.core import expr as E
from repro_torch.core.autodiff import derive, gradients
from repro_torch.db import connect, relation_io, zoo
from repro_torch.db.sql_engine import SQLEngine
from repro_torch.kernels import ops
from repro_torch.nn import moe as nnmoe
from repro_torch.nn import ssm

TOL = 1e-4
DIALECTS = {"relational": None, "array": "array"}


def close(got, want, atol=TOL, msg=""):
    if isinstance(want, torch.Tensor):
        want = want.detach().double().numpy()
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=0, err_msg=msg)


@pytest.fixture(scope="module")
def engines():
    engs = {rep: SQLEngine(dialect=d, plan_cache_=False)
            for rep, d in DIALECTS.items()}
    yield engs
    for e in engs.values():
        e.close()


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

def moe_setup(seed=7):
    cfg = zoo.MoESQLConfig(n_tokens=8, d_model=6, n_experts=4, top_k=2,
                           d_ff=8)
    jcfg = jzoo.MoESQLConfig(**cfg.__dict__)
    params = zoo.init_moe_params(cfg)
    x = np.random.RandomState(seed).randn(8, 6).astype(np.float32)
    return cfg, jcfg, params, x


def slot_relation(cfg, params, x, mode):
    """Route with the port's ``nn/moe.py``; lay the relation token-major."""
    mcfg = nnmoe.MoEConfig(n_experts=cfg.n_experts, top_k=cfg.top_k,
                           d_model=cfg.d_model, d_ff=cfg.d_ff,
                           router_softmax=mode)
    gates, idx, _ = nnmoe._route({"router": torch.from_numpy(
        params["router"])}, torch.from_numpy(x), mcfg)
    t, k = idx.shape
    tok = torch.arange(t, dtype=torch.int32).repeat_interleave(k)
    return tok, idx.reshape(-1), gates.reshape(-1).to(torch.float32)


def ops_moe_chain(cfg, params, x, tok, exp, gates):
    """The port's ops dispatch → per-expert SwiGLU → ops combine."""
    xs = ops.moe_dispatch(torch.from_numpy(x), tok,
                          torch.ones(len(tok))).double().numpy()

    def silu(z):
        return z / (1.0 + np.exp(-z))

    e = exp.numpy()
    ys = np.stack([(xs[s] @ params["wi"][e[s]]
                    * silu(xs[s] @ params["wg"][e[s]])) @ params["wo"][e[s]]
                   for s in range(len(tok))])
    weighted = torch.from_numpy(ys * gates.numpy()[:, None]).float()
    return ops.moe_combine(weighted, tok, cfg.n_tokens)


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("rep", DIALECTS)
def test_moe_layer_equals_repro_and_both_oracles(rep, batched, engines):
    cfg, jcfg, params, x = moe_setup()
    got = zoo.run_moe_in_db(cfg, params, torch.from_numpy(x),
                            engine=engines[rep], batched=batched)
    with JSQLEngine(dialect=DIALECTS[rep], plan_cache_=False) as jeng:
        want = jzoo.run_moe_in_db(jcfg, params, x, engine=jeng,
                                  batched=batched)
    close(got, want)
    close(got, zoo.moe_ffn_ref(cfg, params, x))
    close(got, jzoo.moe_ffn_ref(jcfg, params, x))
    for mode in ("pre", "post"):
        close(got, ops_moe_chain(cfg, params, x,
                                 *slot_relation(cfg, params, x, mode)),
              msg=f"router mode {mode}")


def test_moe_oracle_in_float32_and_float64():
    cfg, jcfg, params, x = moe_setup(seed=3)
    f64 = zoo.moe_ffn_ref(cfg, params, x)
    f32 = zoo.moe_ffn_ref(cfg, params, torch.from_numpy(x),
                          dtype=torch.float32)
    assert f64.dtype == f32.dtype == np.float64
    close(f32, f64)
    close(f64, jzoo.moe_ffn_ref(jcfg, params, x))


@pytest.mark.parametrize("rep", DIALECTS)
def test_moe_dispatch_and_combine_graphs_equal_the_kernels_plain(rep,
                                                                engines):
    cfg, _, params, x = moe_setup()
    tok, _, gates = slot_relation(cfg, params, x, "pre")
    out, _, _, _ = zoo.moe_dispatch_graph(cfg.n_tokens, cfg.d_model,
                                          len(tok))
    tok_rel = tok.double().reshape(-1, 1)
    got, = engines[rep].evaluate([out], {
        "x": x, "slot_token": tok_rel, "slot_gate": gates.reshape(-1, 1)})
    close(got, ops.moe_dispatch(torch.from_numpy(x), tok, gates))
    close(got, jref.moe_dispatch(jnp.asarray(x), jnp.asarray(tok.numpy()),
                                 jnp.asarray(gates.numpy())))
    y = np.random.RandomState(1).randn(len(tok), cfg.d_model).astype(
        np.float32)
    out, _, _ = zoo.moe_combine_graph(len(tok), cfg.d_model, cfg.n_tokens)
    got, = engines[rep].evaluate([out], {"expert_out": y,
                                         "slot_token": tok_rel})
    close(got, ops.moe_combine(torch.from_numpy(y), tok, cfg.n_tokens))
    close(got, jref.moe_combine(jnp.asarray(y), jnp.asarray(tok.numpy()),
                                cfg.n_tokens))


def test_moe_gates_equal_nn_moe_routing(engines):
    cfg, _, params, x = moe_setup()
    graph = zoo.moe_ffn_graph(cfg)
    gm, = engines["relational"].evaluate([graph.gates],
                                         zoo.moe_env(cfg, params, x))
    for mode in ("pre", "post"):
        tok, exp, gates = slot_relation(cfg, params, x, mode)
        want = np.zeros_like(gm)
        want[tok.long().numpy(), exp.numpy()] = gates.numpy()
        close(gm, want, msg=f"router mode {mode}")


@pytest.mark.parametrize("rep", DIALECTS)
def test_moe_gradients_execute_in_db(rep, engines):
    """Algorithm 1 over Softmax/ArgTopK/RowReduce/recip — the full MoE
    backward as SQL — against JAX's and the port's dense engines."""
    cfg, jcfg, params, x = moe_setup()
    graph, jgraph = zoo.moe_ffn_graph(cfg), jzoo.moe_ffn_graph(jcfg)
    env = zoo.moe_env(cfg, params, x)
    g = gradients(graph.out, list(graph.weight_vars))
    jg = jgradients(jgraph.out, list(jgraph.weight_vars))
    roots = [graph.out] + [g[v] for v in graph.weight_vars]
    jroots = [jgraph.out] + [jg[v] for v in jgraph.weight_vars]
    got = engines[rep].evaluate(roots, env)
    want = JEngine("dense").eval_fn(jroots)(
        {k: jnp.asarray(v) for k, v in env.items()})
    mine = Engine("dense", device="cpu").eval_fn(roots)(
        {k: np.asarray(v, np.float32) for k, v in env.items()})
    for k, (a, b, c) in enumerate(zip(got, want, mine)):
        close(a, np.asarray(b), msg=f"root {k}")
        close(a, c, msg=f"root {k} (port dense)")


# ---------------------------------------------------------------------------
# RWKV
# ---------------------------------------------------------------------------

def rwkv_inputs(s, n, seed, zero_state=False):
    rng = np.random.RandomState(seed)
    r, k, v = [rng.randn(s, n).astype(np.float32) * 0.5 for _ in range(3)]
    w = (rng.rand(s, n) * 0.5 + 0.3).astype(np.float32)
    u = (rng.randn(n) * 0.5).astype(np.float32)
    s0 = (np.zeros((n, n), np.float32) if zero_state
          else (rng.randn(n, n) * 0.3).astype(np.float32))
    return r, k, v, w, u, s0


@pytest.mark.parametrize("zero_state", [False, True])
@pytest.mark.parametrize("rep", DIALECTS)
def test_rwkv6_time_mix_equals_the_scan_and_repro(rep, zero_state, engines):
    args = rwkv_inputs(6, 4, seed=7, zero_state=zero_state)
    o, sfin = zoo.run_rwkv6_in_db(*(torch.from_numpy(a) for a in args),
                                  engine=engines[rep])
    to, tsfin = ops.rwkv6_scan(*(torch.from_numpy(a)[None] for a in args))
    close(o, to[0])
    close(sfin, tsfin[0])
    with JSQLEngine(dialect=DIALECTS[rep], plan_cache_=False) as jeng:
        jo, jsfin = jzoo.run_rwkv6_in_db(*args, engine=jeng)
    close(o, jo)
    close(sfin, jsfin)


@pytest.mark.parametrize("rep", DIALECTS)
def test_channel_mix_equals_oracles_and_the_model_layer(rep, engines):
    """The port's numpy oracle equals the reference's; the SQL equals it;
    and ``nn/ssm.py``'s channel mix computes the same function with its
    mixing weights taken as 1 − mu (it mixes ``x + (x_prev − x)·mu``)."""
    rng = np.random.RandomState(9)
    s, d, f = 6, 5, 8
    x = rng.randn(s, d).astype(np.float32)
    mu_k, mu_r = rng.rand(d), rng.rand(d)
    wk, wv, wr = rng.randn(d, f) * 0.3, rng.randn(f, d) * 0.3, \
        rng.randn(d, d) * 0.3
    args = (x, mu_k, mu_r, wk, wv, wr)
    want = zoo.rwkv_channel_mix_ref(*args)
    np.testing.assert_array_equal(want, jzoo.rwkv_channel_mix_ref(*args))
    close(zoo.run_channel_mix_in_db(*args, engine=engines[rep]), want)
    p = {"mu_k": torch.from_numpy(1.0 - mu_k), "mu_r": torch.from_numpy(
        1.0 - mu_r), "wk": torch.from_numpy(wk), "wv": torch.from_numpy(wv),
        "wr": torch.from_numpy(wr)}
    out, _ = ssm.rwkv6_channel_mix(p, torch.from_numpy(x).double()[None])
    close(out[0], want)


def test_kron_index_relations_equal_the_reference():
    for n in (1, 3, 4):
        rel, jrel = zoo.kron_index_relations(n), jzoo.kron_index_relations(n)
        assert rel.keys() == jrel.keys()
        for k in rel:
            np.testing.assert_array_equal(rel[k], jrel[k])
    rng = np.random.RandomState(0)
    k_, v_ = rng.randn(2, 3), rng.randn(2, 3)
    rel = zoo.kron_index_relations(3)
    flat = (k_ @ rel["kron_a"]) * (v_ @ rel["kron_b"])
    close(flat, np.einsum("ta,tb->tab", k_, v_).reshape(2, 9), atol=1e-12)
    for n, p in ((3, 2), (2, 4)):
        rel, jrel = zoo.ssd_kron_relations(n, p), jzoo.ssd_kron_relations(n,
                                                                          p)
        for k in rel:
            np.testing.assert_array_equal(rel[k], jrel[k])


# ---------------------------------------------------------------------------
# SSD (Mamba-2) and LRU
# ---------------------------------------------------------------------------

S, N, P = 6, 3, 2
_R = np.random.RandomState(5)
XV = _R.randn(S, P).astype(np.float32)
AV = -_R.rand(S).astype(np.float32)           # log decay ≤ 0
BV = (_R.randn(S, N) * 0.5).astype(np.float32)
CV = (_R.randn(S, N) * 0.5).astype(np.float32)


def ssd_naive_single(h0=None):
    """The port's ``nn/ssm.ssd_naive`` at B = H = 1."""
    y, h = ssm.ssd_naive(torch.from_numpy(XV)[None, :, None],
                         torch.from_numpy(AV)[None, :, None],
                         torch.from_numpy(BV)[None],
                         torch.from_numpy(CV)[None],
                         None if h0 is None else
                         torch.from_numpy(h0)[None, None])
    return y[0, :, 0], h[0, 0]


def test_ssd_numpy_twin_equals_the_reference_and_ssd_naive():
    y, h = zoo.ssd_ref(XV, AV, BV, CV)
    jy, jh = jzoo.ssd_ref(XV, AV, BV, CV)
    np.testing.assert_array_equal(y, jy)
    np.testing.assert_array_equal(h, jh)
    ty, th = ssd_naive_single()
    close(y, ty, atol=1e-5)
    close(h, th, atol=1e-5)


@pytest.mark.parametrize("chunk", [None, 1, 2, 4])
@pytest.mark.parametrize("rep", DIALECTS)
def test_ssd_in_db_equals_ssd_naive_and_repro(rep, chunk, engines):
    y, h = zoo.run_ssd_in_db(torch.from_numpy(XV), AV, BV, CV, chunk=chunk,
                             engine=engines[rep])
    ty, th = ssd_naive_single()
    close(y, ty)
    close(h, th)
    with JSQLEngine(dialect=DIALECTS[rep], plan_cache_=False) as jeng:
        jy, jh = jzoo.run_ssd_in_db(XV, AV, BV, CV, chunk=chunk, engine=jeng)
    close(y, jy)
    close(h, jh)


def test_ssd_in_db_equals_ssd_chunked(engines):
    """The card's prefill path (``ssd_chunked``, whole chunks of 2 here)."""
    y, h = zoo.run_ssd_in_db(XV, AV, BV, CV, engine=engines["array"])
    ty, th = ssm.ssd_chunked(torch.from_numpy(XV)[None, :, None],
                             torch.from_numpy(AV)[None, :, None],
                             torch.from_numpy(BV)[None],
                             torch.from_numpy(CV)[None], chunk=2)
    close(y, ty[0, :, 0])
    close(h, th[0, 0])


def test_ssd_nonzero_initial_state(engines):
    h0 = (np.random.RandomState(6).randn(N, P) * 0.5).astype(np.float32)
    y, h = zoo.run_ssd_in_db(XV, AV, BV, CV, torch.from_numpy(h0),
                             engine=engines["relational"])
    ry, rh = zoo.ssd_ref(XV, AV, BV, CV, h0)
    close(y, ry)
    close(h, rh)
    ty, th = ssd_naive_single(h0)
    close(y, ty)
    close(h, th)


@pytest.mark.parametrize("rep", DIALECTS)
def test_ssd_gradients_equal_autograd_and_repro(rep, engines):
    """Algorithm 1 on the in-DB graph vs ``torch.autograd`` through the
    port's ``ssd_naive`` (loss Σ y²), and vs the reference's SQL."""
    graph = zoo.ssd_scan_graph(S, N, P)
    xt, bt, ct = graph.leaves[:3]
    g = gradients(E.square(graph.y), [xt, bt, ct])
    got = engines[rep].evaluate([g[xt], g[bt], g[ct]],
                                zoo.ssd_env(XV, AV, BV, CV))
    x, b, c = (torch.from_numpy(a).requires_grad_() for a in (XV, BV, CV))
    y, _ = ssm.ssd_naive(x[None, :, None], torch.from_numpy(AV)[None, :, None],
                         b[None], c[None])
    oracle = torch.autograd.grad(torch.sum(y ** 2), (x, b, c))
    jgraph = jzoo.ssd_scan_graph(S, N, P)
    jx, jb, jc = jgraph.leaves[:3]
    jg = jgradients(JE.square(jgraph.y), [jx, jb, jc])
    with JSQLEngine(dialect=DIALECTS[rep], plan_cache_=False) as jeng:
        want = jeng.evaluate([jg[jx], jg[jb], jg[jc]],
                             jzoo.ssd_env(XV, AV, BV, CV))
    for a, o, w in zip(got, oracle, want):
        close(a, o)
        close(a, w)


class TestLRU:
    D_IN, D, D_OUT = 3, 4, 2
    _r = np.random.RandomState(8)
    U = _r.randn(S, D_IN).astype(np.float32)
    A = (_r.randn(D, D) * 0.3).astype(np.float32)
    LAM = (_r.rand(D) * 0.8).astype(np.float32)
    WB = (_r.randn(D_IN, D) * 0.5).astype(np.float32)
    WC = (_r.randn(D, D_OUT) * 0.5).astype(np.float32)

    def a(self, diagonal):
        return self.LAM if diagonal else self.A

    def torch_loss(self, diagonal, u, a, wb, wc):
        b = u @ wb
        h = torch.zeros(self.D, dtype=u.dtype)
        hs = []
        for t in range(S):
            h = (h * a if diagonal else h @ a) + b[t]
            hs.append(h)
        return torch.sum((torch.stack(hs) @ wc) ** 2)

    @pytest.mark.parametrize("diagonal", [False, True])
    @pytest.mark.parametrize("rep", DIALECTS)
    def test_forward(self, rep, diagonal, engines):
        args = (self.U, self.a(diagonal), self.WB, self.WC)
        want, _ = zoo.lru_ref(*args, diagonal=diagonal)
        jwant, _ = jzoo.lru_ref(*args, diagonal=diagonal)
        np.testing.assert_array_equal(want, jwant)
        y = zoo.run_lru_in_db(*(torch.from_numpy(t) for t in args),
                              diagonal=diagonal, engine=engines[rep])
        close(y, want)

    @pytest.mark.parametrize("diagonal", [False, True])
    @pytest.mark.parametrize("rep", DIALECTS)
    def test_gradients(self, rep, diagonal, engines):
        args = (self.U, self.a(diagonal), self.WB, self.WC)
        _, grads = zoo.lru_grads_in_db(*args, diagonal=diagonal,
                                       engine=engines[rep])
        ts = [torch.from_numpy(t).double().requires_grad_() for t in args]
        oracle = torch.autograd.grad(self.torch_loss(diagonal, *ts), ts)
        with JSQLEngine(dialect=DIALECTS[rep], plan_cache_=False) as jeng:
            _, jgrads = jzoo.lru_grads_in_db(*args, diagonal=diagonal,
                                             engine=jeng)
        assert grads.keys() == jgrads.keys()
        for k in grads:
            close(grads[k], jgrads[k], msg=k)
        close(grads["u"], oracle[0])
        got_a = (grads["lam"].reshape(-1) if diagonal
                 else grads["a_stack"].reshape(S, self.D, self.D).sum(0))
        close(got_a, oracle[1])
        close(grads["wb"], oracle[2])
        close(grads["wc"], oracle[3])


# ---------------------------------------------------------------------------
# the zoo primitives in the database: what the engine twins leave out
# ---------------------------------------------------------------------------

T, C = 5, 4


def _prim_env():
    rng = np.random.RandomState(0)
    return {"x": rng.randn(T, C).astype(np.float32),
            "idx": np.array([[3], [0], [1], [1], [4]], np.float32),
            "a": (rng.rand(T, C) * 0.5).astype(np.float32),
            "b": rng.randn(T, C).astype(np.float32)}


def _prim_roots(E_):
    x, idx = E_.var("x", (T, C)), E_.var("idx", (T, 1))
    a, b = E_.var("a", (T, C)), E_.var("b", (T, C))
    return [E_.row_reduce(x, "sum", 1), E_.row_reduce(x, "max", 0),
            E_.softmax(x), E_.hadamard(E_.argtopk(x, 2), x),
            E_.gather(x, idx), E_.scatter(E_.gather(x, idx), idx, T),
            E_.row_shift(x, 1), E_.row_shift(x, -2),
            E_.recurrence(a, b), E_.recurrence(a, b, reverse=True)]


@pytest.mark.parametrize("rep", DIALECTS)
def test_zoo_gradient_dags_execute_in_db(rep, engines):
    """The gradient DAGs (ReduceDeriv indicators, reverse scans, shift and
    gather adjoints) run as SQL and equal JAX's dense engine on the
    reference's own gradient graphs."""
    env = _prim_env()
    jenv = {k: jnp.asarray(v) for k, v in env.items()}
    for root, jroot in zip(_prim_roots(E), _prim_roots(JE)):
        seed = np.random.RandomState(1).randn(*root.shape)
        gr = derive(root, E.var("seed", root.shape))
        jgr = jderive(jroot, JE.var("seed", jroot.shape))
        names = sorted(v.name for v in gr if v.name not in ("idx", "seed"))
        tg = {v.name: g for v, g in gr.items()}
        jg = {v.name: g for v, g in jgr.items()}
        got = engines[rep].evaluate([tg[n] for n in names],
                                    {**env, "seed": seed})
        want = JEngine("dense").eval_fn([jg[n] for n in names])(
            {**jenv, "seed": jnp.asarray(seed, jnp.float32)})
        for n, a, b in zip(names, got, want):
            close(a, np.asarray(b), msg=f"{type(root).__name__} d/d{n}")


def _sql_outputs(roots, env, engines):
    return {rep: eng.evaluate(roots, env) for rep, eng in engines.items()}


def test_argtopk_boundary_ties_pin_the_smaller_column(engines):
    x = np.array([[1.0, 3.0, 3.0, 0.0], [5.0, 2.0, 2.0, 2.0],
                  [7.0, 7.0, 7.0, 7.0]], np.float32)
    want = np.array([[0, 1, 1, 0], [1, 1, 0, 0], [1, 1, 0, 0]], np.float64)
    roots = [E.argtopk(E.var("x", x.shape), 2)]
    for rep, got in _sql_outputs(roots, {"x": x}, engines).items():
        np.testing.assert_array_equal(got[0], want, err_msg=rep)
    np.testing.assert_array_equal(
        dense.topk_mask(torch.from_numpy(x), 2).numpy(), want)


def test_scatter_collisions_accumulate_and_holes_stay_zero(engines):
    x = np.array([[1.0, 10.0], [2.0, 20.0], [4.0, 40.0], [8.0, 80.0],
                  [16.0, 160.0]], np.float32)
    idx = np.array([[0.0], [2.0], [0.0], [2.0], [2.0]], np.float32)
    want = np.array([[5.0, 50.0], [0.0, 0.0], [26.0, 260.0], [0.0, 0.0]])
    roots = [E.scatter(E.var("x", x.shape), E.var("idx", idx.shape), 4)]
    for rep, got in _sql_outputs(roots, {"x": x, "idx": idx},
                                 engines).items():
        close(got[0], want, msg=rep)


def test_zero_row_relations(engines):
    with connect("sqlite") as ad:
        relation_io.write_matrix(ad, "empty", torch.zeros((0, 4)))
        assert relation_io.read_matrix(ad, "empty", (0, 4)).shape == (0, 4)
        relation_io.write_matrix_array(ad, "empty_a", np.zeros((0, 4)))
        assert relation_io.read_matrix_array(ad, "empty_a").shape == (0, 4)
    x, eidx = E.var("x", (0, 3)), E.var("eidx", (0, 1))
    env = {"x": np.zeros((0, 3), np.float32),
           "w": np.arange(6, dtype=np.float32).reshape(3, 2),
           "eidx": np.zeros((0, 1), np.float32)}
    roots = [E.matmul(x, E.var("w", (3, 2))),
             E.gather(E.var("w", (3, 2)), eidx), E.scatter(x, eidx, 4)]
    for rep, got in _sql_outputs(roots, env, engines).items():
        assert got[0].shape == got[1].shape == (0, 2), rep
        np.testing.assert_array_equal(got[2], np.zeros((4, 3)), err_msg=rep)


def test_softmax_at_750_stays_finite(engines):
    x = np.array([[750.0, 749.0, -750.0], [-750.0, -749.5, -748.0],
                  [750.0, 750.0, 0.0]], np.float32)
    xd = x.astype(np.float64)
    e = np.exp(xd - xd.max(axis=1, keepdims=True))
    want = e / e.sum(axis=1, keepdims=True)
    roots = [E.softmax(E.var("x", x.shape))]
    for rep, got in _sql_outputs(roots, {"x": x}, engines).items():
        assert np.isfinite(got[0]).all(), rep
        close(got[0], want, msg=rep)


def test_non_finite_scan_states_propagate(engines):
    a, b = E.var("ra", (3, 2)), E.var("rb", (3, 2))
    env = {"ra": np.ones((3, 2)),
           "rb": np.array([[np.nan, 1.0], [np.inf, 2.0], [3.0, -np.inf]])}
    want = np.array([[np.nan, 1.0], [np.nan, 3.0], [np.nan, -np.inf]])
    for rep, got in _sql_outputs([E.recurrence(a, b)], env,
                                 engines).items():
        np.testing.assert_array_equal(got[0], want, err_msg=rep)
    ma, mb = E.var("nfa", (9, 3)), E.var("nfb", (3, 3))
    bv = np.zeros((3, 3))
    bv[2] = [np.nan, np.inf, -np.inf]
    env = {"nfa": np.tile(np.eye(3), (3, 1)), "nfb": bv}
    for rep, got in _sql_outputs([E.mat_recurrence(ma, mb)], env,
                                 engines).items():
        np.testing.assert_array_equal(got[0][2], bv[2], err_msg=rep)
        np.testing.assert_array_equal(got[0][:2], np.zeros((2, 3)),
                                      err_msg=rep)


@pytest.mark.parametrize("seed", range(6))
def test_gather_scatter_adjoint_in_sqlite(seed, engines):
    """⟨gather(x, idx), y⟩ = ⟨x, scatter(y, idx)⟩ for any index multiset
    (duplicates and gaps), evaluated by sqlite; dense agrees."""
    rng = np.random.RandomState(seed)
    r, c, s = rng.randint(1, 7), rng.randint(1, 6), rng.randint(1, 9)
    x = rng.randn(r, c).astype(np.float32)
    y = rng.randn(s, c).astype(np.float32)
    idx = rng.randint(0, r, (s, 1)).astype(np.float64)
    xv, yv, iv = E.var("x", (r, c)), E.var("y", (s, c)), E.var("idx",
                                                                (s, 1))
    roots = [E.gather(xv, iv), E.scatter(yv, iv, r)]
    env = {"x": x, "y": y, "idx": idx}
    dense_out = Engine("dense", device="cpu").eval_fn(roots)(env)
    for rep, (g, sc) in _sql_outputs(roots, env, engines).items():
        close(g, dense_out[0], msg=rep)
        close(sc, dense_out[1], msg=rep)
        assert abs(float((g * y).sum()) - float((x * sc).sum())) <= 1e-3 * (
            1 + abs(float((g * y).sum())))


def test_module_surface_equals_the_reference():
    assert sorted(zoo.__all__) == sorted(jzoo.__all__)
    import repro_torch.db as db
    assert db.zoo is zoo

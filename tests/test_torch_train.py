"""Twins of the JAX package's LM training for the port: ``LM.loss_fn``
(its three ``loss_impl``s) and its gradient against
``jax.value_and_grad(LM.loss_fn)`` on the reduced Yi-6B, the loss and
gradient of every reduced family, one ``make_train_step`` with AdamW
against JAX's jitted step, gradient accumulation, the ``Trainer``'s
restart, ``StragglerMonitor``, the ``TokenPipeline`` contract and the
training launcher on the CPU.  (``tests/test_substrates.py`` holds the
JAX side of the same contracts.)

JAX parameters from ``LM.init(PRNGKey(0))`` pass through
``convert.from_jax_params``; batches are numpy.  Tolerances: with the
compute type float32 in both packages (monkeypatched, here only) loss and
gradients at rtol 1e-4, atol 1e-5 — float32 sums over the batch's tokens
and the model's widths in another order, through the recomputed layers
of ``remat="full"``; in the packages' own bf16 compute,
``tests/test_torch_model.py``'s BF16 (rtol 0.08, atol 0.05).  The train
step and accumulation at ``tests/test_substrates.py``'s 2e-4 / 2e-5.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.nn.layers as JL
import repro_torch.nn.layers as TL
from repro.configs.base import get_config as jget_config
from repro.nn.model import LM as JLM
from repro.optim import adamw as jadamw
from repro.train import StragglerMonitor as JStragglerMonitor
from repro.train import make_train_step as jmake_train_step
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.data import TokenPipeline, stub_frontend_batch
from repro_torch.launch import train as launch_train
from repro_torch.nn.model import LM
from repro_torch.optim import adamw, clip_by_global_norm, sgd
from repro_torch.train import StragglerMonitor, Trainer, make_train_step
from repro_torch.tree import leaves, tree_map, unflatten

F32 = dict(rtol=1e-4, atol=1e-5)
BF16 = dict(rtol=0.08, atol=0.05)
STEP = dict(rtol=2e-4, atol=2e-5)
B, S = 2, 12


@pytest.fixture
def f32_compute(monkeypatch):
    monkeypatch.setattr(JL, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(TL, "COMPUTE_DTYPE", torch.float32)


@functools.lru_cache(maxsize=None)
def jax_params(arch):
    return jax.jit(JLM(jget_config(arch, reduced=True)).init)(
        jax.random.PRNGKey(0))


def build(arch, **options):
    """The JAX and port LMs of one reduced config with ``options``
    replaced in both, the JAX parameters and a fresh conversion."""
    jcfg = dataclasses.replace(jget_config(arch, reduced=True), **options)
    cfg = dataclasses.replace(get_config(arch, reduced=True), **options)
    jp = jax_params(arch)
    return JLM(jcfg), jp, LM(cfg, device="cpu"), \
        convert.from_jax_params(jp, device="cpu")


def batch(cfg, seed=0, b=B):
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, cfg.vocab, (b, S)).astype(np.int32)
    if cfg.stub_frontend:
        x = {"embeds": rng.randn(b, S, cfg.d_model).astype(np.float32)}
    else:
        x = {"tokens": rng.randint(0, cfg.vocab, (b, S)).astype(np.int32)}
    x["labels"] = labels
    return ({k: jnp.asarray(v) for k, v in x.items()},
            {k: torch.from_numpy(v) for k, v in x.items()})


def port_value_and_grad(lm, params, tb):
    flat = [p.requires_grad_() for p in leaves(params)]
    loss, metrics = lm.loss_fn(params, tb)
    return loss, metrics, torch.autograd.grad(loss, flat, allow_unused=True)


def check_loss_and_grads(arch, tol, grad_tol=None, **options):
    jlm, jp, lm, params = build(arch, **options)
    jb, tb = batch(lm.cfg)
    (jloss, jmetrics), jgrads = jax.jit(
        jax.value_and_grad(jlm.loss_fn, has_aux=True))(jp, jb)
    loss, metrics, grads = port_value_and_grad(lm, params, tb)
    assert loss.dtype == torch.float32 and loss.shape == ()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), **tol)
    for k in ("ce", "aux"):
        np.testing.assert_allclose(float(metrics[k].detach()),
                                   float(jmetrics[k]), **tol)
    names = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(jgrads)[0]]
    for name, g, j in zip(names, grads, jax.tree.leaves(jgrads),
                          strict=True):
        g = torch.zeros(j.shape) if g is None else g
        j = np.asarray(j, np.float32)
        gtol = dict(grad_tol or tol)
        if grad_tol:      # the atol in units of the leaf's largest entry
            gtol["atol"] *= max(1.0, float(np.abs(j).max()))
        np.testing.assert_allclose(g.float().numpy(), j,
                                   err_msg=f"{arch} grad {name}", **gtol)
    return float(loss.detach())


@pytest.mark.parametrize("loss_impl", ["full", "onehot", "chunked"])
def test_loss_fn_matches_jax_in_float32(f32_compute, loss_impl):
    """Loss, metrics and every gradient leaf; "chunked" in vocabulary
    chunks of 100, so the last of the 256 is ragged."""
    check_loss_and_grads("yi_6b", F32, loss_impl=loss_impl, loss_chunk=100)


@pytest.mark.parametrize("loss_impl", ["full", "chunked"])
def test_loss_fn_matches_jax_in_bf16(loss_impl):
    check_loss_and_grads("yi_6b", BF16, loss_impl=loss_impl, loss_chunk=100)


@pytest.mark.parametrize("arch,options", [
    ("internvl2_1b", {}), ("musicgen_medium", {}),
    ("deepseek_v2_lite_16b", "sort"), ("rwkv6_7b", {}),
    ("zamba2_2_7b", {})], ids=["vlm", "audio", "moe_sort", "ssm", "hybrid"])
def test_every_family_trains_like_jax(f32_compute, arch, options):
    """The other families' loss and gradients on the CPU, through the
    plain versions of their kernels (the moe family in its relational
    form, ``impl="sort"``), the loss at F32, the gradients at
    ``tests/test_torch_model.py``'s float32 twin tolerance (rtol 2e-4,
    atol 2e-5), the atol in units of each leaf's largest entry where that
    exceeds 1: the RWKV-6 recurrence and the hybrid's mixers amplify
    float32 rounding (``tests/test_torch_model.py``), and the hybrid's
    embedding gradient (entries up to 7.9, summed over the main stream and
    every shared-block use) differs by up to 3.8e-5."""
    if options == "sort":
        cfg = jget_config(arch, reduced=True)
        options = dict(moe=dataclasses.replace(cfg.moe, impl="sort"))
    check_loss_and_grads(arch, F32, grad_tol=STEP, **options)


def test_remat_changes_nothing_and_dots_waits():
    """``remat`` "none", "full" and "dots" give the same loss and gradients
    bit for bit in the packages' own bf16 compute (the name is kept from
    when "dots" waited for a later slice; ``tests/test_torch_remat_dots.py``
    holds it against JAX)."""
    _, _, lm, params = build("yi_6b")
    _, tb = batch(lm.cfg)
    loss, _, full = port_value_and_grad(lm, params, tb)
    for remat in ("none", "dots"):
        other = LM(dataclasses.replace(lm.cfg, remat=remat), device="cpu")
        loss2, _, grads = port_value_and_grad(other, params, tb)
        assert torch.equal(loss, loss2), remat
        assert all(torch.equal(a, b) for a, b in zip(full, grads)), remat


def test_train_step_matches_jax(f32_compute):
    """One AdamW step (clip 1.0) on the same parameters and batch: every
    parameter, m, v and t, and the metrics.  With eps 1e-6: AdamW's first
    step is g / (|g| + eps) a parameter, and some gradient entries here are
    1e-8 to 1e-7, float32 noise that differs by a few per cent between the
    packages; at the default eps 1e-8 that noise alone decides how far
    such a parameter moves (by up to 1.4e-4 at lr 1e-2)."""
    jlm, jp, lm, params = build("yi_6b")
    jb, tb = batch(lm.cfg, b=4)
    jopt, opt = jadamw(1e-2, eps=1e-6), adamw(1e-2, eps=1e-6)
    jp2, jst2, jm = jax.jit(jmake_train_step(jlm.loss_fn, jopt))(
        jp, jopt.init(jp), jb)
    p2, st2, m = make_train_step(lm.loss_fn, opt)(params, opt.init(params),
                                                  tb)
    for a, b in zip(leaves((p2, st2)), jax.tree.leaves((jp2, jst2)),
                    strict=True):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **STEP)
    for k in ("loss", "grad_norm", "ce", "aux"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), **STEP)


def test_grad_accum_matches_full_batch():
    _, _, lm, params = build("yi_6b")
    tb = TokenPipeline(vocab=lm.cfg.vocab, seq_len=16, global_batch=8,
                       device="cpu").batch_at(0)
    opt = sgd(0.1)
    copy = {k: v.clone() for k, v in leaves_dict(params).items()}
    p1, _, m1 = make_train_step(lm.loss_fn, opt, grad_accum=1)(
        params, (), tb)
    p1 = [t.clone() for t in leaves(p1)]
    p2, _, m2 = make_train_step(lm.loss_fn, opt, grad_accum=4)(
        restore(params, copy), (), tb)
    for a, b in zip(p1, leaves(p2)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **STEP)
    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]), **STEP)


def in_place_step(lm, opt, params, state, batch, grad_accum, clip_norm):
    """The step as ``make_train_step`` ran it before the clip left the
    division to the update: the microbatches' gradients summed into
    ``.grad``, divided in place, clipped in place, then AdamW.  Returns
    the norm."""
    flat = [p.detach().requires_grad_() for p in leaves(params)]
    tracked = unflatten(params, flat)
    size = next(iter(batch.values())).shape[0] // grad_accum
    for i in range(grad_accum):
        micro = {k: v[i * size:(i + 1) * size] for k, v in batch.items()}
        loss, _ = lm.loss_fn(tracked, micro)
        loss.backward()
    acc = [p.grad if p.grad is not None else torch.zeros_like(p)
           for p in flat]
    if grad_accum > 1:
        for g in acc:
            g.div_(grad_accum)
    grads, norm = clip_by_global_norm(unflatten(params, acc), clip_norm)
    opt.update(grads, state, params)
    return norm


@pytest.mark.parametrize("clip_norm", [0.1, 1e6], ids=["clipped",
                                                       "unclipped"])
@pytest.mark.parametrize("grad_accum", [1, 2, 3])
def test_train_step_is_the_in_place_sequence_bit_for_bit(grad_accum,
                                                         clip_norm):
    """Two steps of ``make_train_step`` with AdamW, whose update now takes
    the division and the clip from ``clip_by_global_norm(...,
    divide_by=)``: the same ``grad_norm`` (of the averaged gradients,
    before the clip) and the same parameters and state, bit for bit, as
    the sequence of in-place passes the step ran before."""
    cfg = get_config("yi_6b", reduced=True)
    lm = LM(cfg, device="cpu")
    data = TokenPipeline(vocab=cfg.vocab, seq_len=8, global_batch=6,
                         device="cpu")
    opt = adamw(1e-2)
    params = lm.init(torch.Generator().manual_seed(0))
    old = tree_map(torch.clone, params)
    state, old_state = opt.init(params), opt.init(old)
    step = make_train_step(lm.loss_fn, opt, grad_accum, clip_norm)
    for i in range(2):
        batch = data.batch_at(i)
        params, state, metrics = step(params, state, batch)
        norm = in_place_step(lm, opt, old, old_state, batch, grad_accum,
                            clip_norm)
        assert torch.equal(metrics["grad_norm"], norm)
    assert (float(norm) > clip_norm) == (clip_norm < 1)
    for a, b in zip(leaves((params, state)), leaves((old, old_state)),
                    strict=True):
        assert torch.equal(a, b)


def test_train_step_with_sgd_applies_the_scale_first():
    """An optimizer that does not fold the scale in (SGD) gets gradients
    already divided and clipped: the in-place sequence, bit for bit."""
    cfg = get_config("yi_6b", reduced=True)
    lm = LM(cfg, device="cpu")
    tb = TokenPipeline(vocab=cfg.vocab, seq_len=8, global_batch=4,
                       device="cpu").batch_at(0)
    params = lm.init(torch.Generator().manual_seed(1))
    old = tree_map(torch.clone, params)
    _, _, metrics = make_train_step(lm.loss_fn, sgd(0.1), 2, 0.1)(
        params, (), tb)
    norm = in_place_step(lm, sgd(0.1), old, (), tb, 2, 0.1)
    assert torch.equal(metrics["grad_norm"], norm)
    assert all(torch.equal(a, b) for a, b in zip(leaves(params),
                                                  leaves(old)))


def leaves_dict(params):
    return dict(enumerate(leaves(params)))


def restore(params, copy):
    for i, t in enumerate(leaves(params)):
        t.data.copy_(copy[i])
    return params


def test_grad_accum_sums_in_float32_for_bf16_params():
    """bf16 parameters (``param_dtype``): the microbatch gradients are
    summed into float32 buffers, as JAX's scan carries them."""
    lm = LM(dataclasses.replace(get_config("yi_6b", reduced=True),
                                param_dtype="bfloat16"), device="cpu")
    params = lm.init(torch.Generator().manual_seed(0))
    seen = {}

    class Spy:
        def init(self, p):
            return ()

        def update(self, grads, state, p):
            seen["dtypes"] = {g.dtype for g in leaves(grads)}
            return p, state

    tb = TokenPipeline(vocab=lm.cfg.vocab, seq_len=8, global_batch=4,
                       device="cpu").batch_at(0)
    make_train_step(lm.loss_fn, Spy(), grad_accum=2)(params, (), tb)
    assert seen["dtypes"] == {torch.float32}


def trainer(td):
    cfg = get_config("yi_6b", reduced=True)
    data = TokenPipeline(vocab=cfg.vocab, seq_len=16, global_batch=4,
                         device="cpu")
    return Trainer(LM(cfg, device="cpu"), adamw(1e-3), data,
                   checkpoint_dir=str(td), checkpoint_every=3)


def test_loss_decreases_and_restart_resumes(tmp_path):
    out = trainer(tmp_path).run(torch.Generator().manual_seed(0), 6,
                                log_every=0)
    hist = out["history"]
    assert [h["step"] for h in hist] == list(range(6))
    assert hist[-1]["loss"] < hist[0]["loss"]
    assert all(np.isfinite(h["grad_norm"]) for h in hist)
    # simulated crash: a fresh trainer resumes at step 6, bit for bit
    params, state, start = trainer(tmp_path).restore_or_init(
        torch.Generator().manual_seed(9))
    assert start == 6 and int(state["t"]) == 6
    for a, b in zip(leaves((params, state)),
                    leaves((out["params"], out["opt_state"]))):
        assert torch.equal(a, b)


def test_trainer_without_donation_keeps_its_inputs():
    cfg = get_config("yi_6b", reduced=True)
    tr = Trainer(LM(cfg, device="cpu"), adamw(1e-3),
                 TokenPipeline(cfg.vocab, 8, 2, device="cpu"), donate=False)
    params, state = tr.init_state(torch.Generator().manual_seed(0))
    before = [t.clone() for t in leaves(params)]
    new, _, _ = tr.step_fn(params, state, tr.data.batch_at(0))
    assert all(torch.equal(a, b) for a, b in zip(before, leaves(params)))
    assert not all(torch.equal(a, b) for a, b in zip(before, leaves(new)))


def test_straggler_monitor_flags_what_jax_flags():
    times = [0.1] * 10 + [1.0, 0.1, 0.35, 0.29, 0.1] + [0.5] * 40 + [2.0]
    ours, theirs = StragglerMonitor(window=10), JStragglerMonitor(window=10)
    for i, t in enumerate(times):
        assert ours.record(i, t) == theirs.record(i, t)
    assert ours.flagged == theirs.flagged and 10 in ours.flagged


def test_token_pipeline_contract():
    """Deterministic, host shards concatenate to the global batch, labels
    are the next tokens, and a restarted pipeline reproduces the stream;
    int32 tensors on the device asked for."""
    full = TokenPipeline(vocab=100, seq_len=8, global_batch=4, device="cpu")
    shards = [TokenPipeline(vocab=100, seq_len=8, global_batch=4, host_id=h,
                            n_hosts=2, device="cpu") for h in (0, 1)]
    b = full.batch_at(3)
    assert b["tokens"].dtype == torch.int32 and b["tokens"].shape == (4, 8)
    assert torch.equal(b["tokens"][:, 1:], b["labels"][:, :-1])
    assert int(b["tokens"].max()) < 100 and int(b["tokens"].min()) >= 0
    assert torch.equal(torch.cat([s.batch_at(3)["tokens"] for s in shards]),
                       b["tokens"])
    again = TokenPipeline(vocab=100, seq_len=8, global_batch=4, device="cpu")
    assert torch.equal(again.batch_at(3)["labels"], b["labels"])
    assert not torch.equal(full.batch_at(4)["tokens"], b["tokens"])
    with pytest.raises(ValueError, match="divide"):
        TokenPipeline(vocab=100, seq_len=8, global_batch=3, n_hosts=2,
                      device="cpu")


def test_stub_frontend_batch():
    b = stub_frontend_batch("audio_frames", 2, 5, 16, 50, seed=1,
                            device="cpu")
    assert b["embeds"].shape == (2, 5, 16) and b["embeds"].dtype == \
        torch.float32
    assert b["labels"].dtype == torch.int32 and int(b["labels"].max()) < 50
    again = stub_frontend_batch("audio_frames", 2, 5, 16, 50, seed=1,
                                device="cpu")
    assert torch.equal(again["embeds"], b["embeds"])


@pytest.mark.parametrize("arch", ["yi_6b", "musicgen_medium"])
def test_train_launcher_on_the_cpu(capsys, arch):
    launch_train.main(["--arch", arch, "--reduced", "--device", "cpu",
                       "--steps", "3", "--seq", "16", "--batch", "4"])
    out = capsys.readouterr().out
    assert "step     0 loss" in out and out.strip().splitlines()[-1] \
        .startswith("done: loss")

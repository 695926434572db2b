"""The plain references: the MLP's against Listing 2's NumPy training,
DeepSeek's against the port at float32 (where the two compute one
function, so they agree to float32 rounding), and the input makers'
tree against the port's own."""
import numpy as np
import torch

from portbench import inputs
from portbench.reference import deepseek, listing2, mlp, numerics
from portbench.tests import small


def test_mlp_reference_is_listing2():
    gen = inputs.generator(2 ** 31 + 17, "cpu")
    x, labels = inputs.mnist_like(200, 30, 5, gen)
    w0 = inputs.listing2_weights(30, 12, 5, gen)
    want = listing2.numpy_train(
        x.double().numpy(), np.eye(5)[labels.numpy()],
        w0["w_xh"].double().numpy(), w0["w_ho"].double().numpy(), 3, 0.01)
    got = mlp.train(x, labels, w0, 0.01, 3)[-1]
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=1e-12,
                                   atol=1e-12)


def test_mlp_inputs_are_make_mnist_like():
    x, labels = inputs.mnist_like(500, 784, 10,
                                  inputs.generator(3, "cpu"))
    assert x.shape == (500, 784) and x.dtype == torch.float32
    assert 0 <= float(x.min()) and float(x.max()) < 1
    assert set(labels.tolist()) <= set(range(10))
    again, _ = inputs.mnist_like(500, 784, 10, inputs.generator(3, "cpu"))
    assert torch.equal(x, again)


def test_token_stream_is_a_function_of_the_seed():
    a = inputs.TokenStream(1000, 16, 4, 2 ** 31 + 5, "cpu")
    b = inputs.TokenStream(1000, 16, 4, 2 ** 31 + 5, "cpu")
    assert torch.equal(a.batch_at(3)["tokens"], b.batch_at(3)["tokens"])
    batch = a.batch_at(0)
    assert torch.equal(batch["tokens"][:, 1:], batch["labels"][:, :-1])
    assert not torch.equal(a.batch_at(0)["tokens"], a.batch_at(1)["tokens"])


def _config():
    import json
    from portbench.tests.conftest import ROOT
    c = json.loads((ROOT / "portbench/configs/deepseek-v2-lite-5l.json")
                   .read_text())
    c.update(small.DEEPSEEK)
    return c


def test_lm_weights_have_the_ports_tree():
    from repro_torch.nn.model import LM
    from portbench.drivers.lm_train import arch_config
    c = _config()
    traffic = {"remat": "full", "loss_impl": "full"}
    port = LM(arch_config(c, traffic), device="cpu").init(
        torch.Generator().manual_seed(0))
    ours = inputs.lm_weights(c, inputs.generator(0, "cpu"))
    shapes = lambda t: {n: tuple(v.shape) for n, v in deepseek.leaf_items(t)}
    assert shapes(port) == shapes(ours)
    assert inputs.n_params(c) == sum(v.numel() for _, v in
                                     deepseek.leaf_items(ours))


def test_deepseek_reference_is_the_ports_function_in_float32(monkeypatch):
    """Both in float32 on the CPU: the loss and every gradient leaf agree
    to float32 rounding, so the reference computes the port's model."""
    import repro_torch.nn.layers as layers
    from repro_torch.nn.model import LM
    from repro_torch.tree import leaves, unflatten
    from portbench.drivers.lm_train import arch_config
    monkeypatch.setattr(layers, "COMPUTE_DTYPE", torch.float32)
    c = _config()
    traffic = {"remat": "full", "loss_impl": "full"}
    params = inputs.lm_weights(c, inputs.generator(11, "cpu"))
    batch = inputs.TokenStream(c["vocab_size"], 64, 2, 11, "cpu").batch_at(0)
    flat = [t.detach().requires_grad_() for t in leaves(params)]
    lm = LM(arch_config(c, traffic), device="cpu")
    loss, _ = lm.loss_fn(unflatten(params, flat), batch)
    grads = torch.autograd.grad(loss, flat)
    names, ref_flat = zip(*deepseek.leaf_items(params))
    tracked = [t.detach().requires_grad_() for t in ref_flat]
    model = deepseek.Model(c, "float32")
    ref_loss = model.loss(deepseek._rebuild(params, dict(zip(names,
                                                             tracked))),
                          batch["tokens"], batch["labels"])
    ref_grads = torch.autograd.grad(ref_loss, tracked)
    loss, ref_loss = float(loss.detach()), float(ref_loss.detach())
    assert abs(loss - ref_loss) <= 1e-6 * abs(ref_loss)
    for name, g, r in zip(names, grads, ref_grads):
        assert float((g - r).abs().max()) <= 1e-5 * float(r.abs().max()) \
            + 1e-9, name


def test_numerics_round_as_stated():
    x = torch.tensor([1.0 + 2 ** -12, 1.0 + 2 ** -10, 3.0])
    assert numerics.tf32(x).tolist() == [1.0, 1.0 + 2 ** -10, 3.0]
    y = torch.randn(1000) * 0.01
    low = numerics.fp8(y)
    assert low.dtype == torch.bfloat16
    assert torch.equal(numerics.fp8(low), low)          # already on the grid
    rel = ((low.float() - y).abs() / y.abs().max()).max()
    assert 0 < float(rel) <= 2 ** -4

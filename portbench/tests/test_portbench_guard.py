"""The import guard compares whole top-level names."""
import io

from portbench import guard, run
from portbench.tests import small


def test_forbidden_top_level_names():
    names = ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen", "repro",
             "repro.core.engine", "repro_torch", "repro_torch.core",
             "jaxtyping", "reprolib", "torch"]
    assert guard.forbidden_loaded(names) == sorted(
        ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen", "repro",
         "repro.core.engine"])


def test_nothing_forbidden_is_loaded_by_a_run():
    out = io.StringIO()
    rc = run.main(["--workload", "mlp-mnist-60k.train-array", "--seed", "1",
                   "--seconds", "0.1"], device="cpu", resize=small.resize,
                  out=out)
    assert rc == 0 and out.getvalue()


def test_a_run_that_loaded_the_jax_package_prints_no_result(monkeypatch):
    import sys
    import types
    monkeypatch.setitem(sys.modules, "repro", types.ModuleType("repro"))
    out = io.StringIO()
    rc = run.main(["--workload", "mlp-mnist-60k.train-array", "--seed", "1",
                   "--seconds", "0.1"], device="cpu", resize=small.resize,
                  out=out)
    assert rc == 3 and out.getvalue() == ""

"""The port stands alone: no module of ``src/repro_torch`` and not
``chip_smoke.py`` imports JAX or the JAX package ``repro`` (``repro_torch``
itself is allowed), and ``chip_smoke.py`` ends on the result line the chip
check reads.  An AST scan, so nothing here imports the port."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
SMOKE = ROOT / "chip_smoke.py"


def imported_modules(path: Path) -> list[str]:
    mods = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            mods += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods.append(node.module)
    return mods


def forbidden(mod: str) -> bool:
    top = mod.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


def test_the_port_has_modules():
    names = {p.relative_to(ROOT / "src").as_posix() for p in PORT}
    assert {"repro_torch/core/expr.py", "repro_torch/core/autodiff.py",
            "repro_torch/kernels/ops.py", "repro_torch/data/pipeline.py",
            "repro_torch/convert.py", "repro_torch/configs/base.py",
            "repro_torch/configs/yi_6b.py", "repro_torch/obs/tracer.py",
            "repro_torch/obs/metrics.py", "repro_torch/kernels/ref.py",
            "repro_torch/kernels/flash_attention.py",
            "repro_torch/nn/layers.py", "repro_torch/nn/model.py",
            "repro_torch/nn/ssm.py", "repro_torch/kernels/rwkv6_scan.py",
            "repro_torch/nn/moe.py", "repro_torch/kernels/moe_dispatch.py",
            "repro_torch/serving/engine.py",
            "repro_torch/launch/serve.py", "repro_torch/core/sqlgen.py",
            "repro_torch/db/__init__.py", "repro_torch/db/dialect.py",
            "repro_torch/db/adapter.py", "repro_torch/db/adapters/base.py",
            "repro_torch/db/adapters/sqlite.py",
            "repro_torch/db/adapters/duckdb.py",
            "repro_torch/db/adapters/postgres.py",
            "repro_torch/db/relation_io.py", "repro_torch/db/plan_cache.py",
            "repro_torch/db/sql_engine.py", "repro_torch/db/train.py",
            "repro_torch/obs/export.py",
            "repro_torch/obs/profiler.py", "repro_torch/obs/regress.py",
            "repro_torch/obs/report.py", "repro_torch/launch/mesh.py",
            "repro_torch/db/shard.py", "repro_torch/db/zoo/__init__.py",
            "repro_torch/db/zoo/moe_to_sql.py",
            "repro_torch/db/zoo/rwkv_to_sql.py",
            "repro_torch/db/zoo/ssm_to_sql.py",
            "repro_torch/serving/db_serve.py", "repro_torch/tree.py",
            "repro_torch/optim/optimizers.py",
            "repro_torch/optim/compression.py",
            "repro_torch/checkpoint/checkpointer.py",
            "repro_torch/train/trainer.py",
            "repro_torch/launch/train.py", "repro_torch/launch/specs.py",
            "repro_torch/launch/sharding.py", "repro_torch/launch/dryrun.py",
            "repro_torch/roofline/analysis.py",
            "repro_torch/kernels/meta.py",
            "repro_torch/examples/__init__.py",
            "repro_torch/examples/quickstart.py",
            "repro_torch/examples/mnist_e2e.py",
            "repro_torch/examples/train_in_db.py",
            "repro_torch/examples/observe_in_db.py",
            "repro_torch/examples/zoo_in_db.py",
            "repro_torch/examples/serve_lm.py",
            "repro_torch/examples/train_lm.py"} <= names


@pytest.mark.parametrize("path", PORT + [SMOKE],
                         ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_and_no_reference_imports(path):
    bad = [m for m in imported_modules(path) if forbidden(m)]
    assert not bad, f"{path.name} imports {bad}"


def test_the_scan_catches_what_it_should():
    assert forbidden("jax.numpy") and forbidden("repro.core.expr")
    assert forbidden("repro") and not forbidden("repro_torch.core")


def test_chip_smoke_fails_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    run = subprocess.run([sys.executable, str(SMOKE)], capture_output=True,
                         text=True, timeout=120, cwd=ROOT)
    assert run.returncode != 0
    assert '"ok"' not in run.stdout


def test_chip_smoke_ends_on_the_contract_line():
    """The last print writes {"ok": True, "device": {"platform": "gpu",
    "kind": ..., "count": ...}}."""
    tree = ast.parse(SMOKE.read_text())
    main = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    prints = [n for n in ast.walk(main) if isinstance(n, ast.Call)
              and isinstance(n.func, ast.Name) and n.func.id == "print"]
    last = max(prints, key=lambda n: n.lineno)
    payload = last.args[0]
    assert isinstance(payload, ast.Call) and payload.func.attr == "dumps"
    result = payload.args[0]
    keys = [k.value for k in result.keys]
    assert keys == ["ok", "device"]
    assert result.values[0].value is True
    device = result.values[1]
    assert [k.value for k in device.keys] == ["platform", "kind", "count"]
    assert device.values[0].value == "gpu"
    kind, count = (ast.unparse(v) for v in device.values[1:])
    assert kind == "torch.cuda.get_device_name(0)"
    assert count == "torch.cuda.device_count()"

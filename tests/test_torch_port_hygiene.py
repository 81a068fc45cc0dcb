"""The port stands alone: no JAX, no JAX package, and no silent CPU fallback."""

import ast
from pathlib import Path

import pytest
import torch

import climateparameterizations_jl_tpu_torch as port
from climateparameterizations_jl_tpu_torch import benchmarks
from climateparameterizations_jl_tpu_torch.bridge import from_reference
from climateparameterizations_jl_tpu_torch.closures import mlp
from climateparameterizations_jl_tpu_torch.ops import fused_rhs
from climateparameterizations_jl_tpu_torch.physics.mpp import MPPParameters
from climateparameterizations_jl_tpu_torch.train import checkpoint

REPO = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((REPO / "climateparameterizations_jl_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
FORBIDDEN = {"jax", "jaxlib", "climateparameterizations_jl_tpu"}


def _top_level_imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_port_files_found():
    assert len(PORT_FILES) > 15
    names = {str(p.relative_to(REPO / "climateparameterizations_jl_tpu_torch")) for p in PORT_FILES[:-1]}
    assert {"cli/__main__.py", "cli/main.py", "closures/gp.py", "models/gp_closure.py", "ops/gram.py",
            "ops/cholesky.py"} <= names


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_imports(path):
    # Whole names: climateparameterizations_jl_tpu_torch begins with a forbidden one.
    bad = set(_top_level_imports(path)) & FORBIDDEN
    assert not bad, f"{path} imports {sorted(bad)}"


def test_scan_catches_forbidden_import(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import climateparameterizations_jl_tpu_torch\nfrom climateparameterizations_jl_tpu.ops import x\n")
    assert set(_top_level_imports(f)) & FORBIDDEN == {"climateparameterizations_jl_tpu"}


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_resolve_device_raises_without_card(no_card):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port.resolve_device()
    with pytest.raises(RuntimeError):
        port.resolve_device("cuda")


def test_resolve_device_cpu_when_asked(no_card):
    assert port.resolve_device("cpu") == torch.device("cpu")


def test_entry_points_raise_without_card(no_card):
    with pytest.raises(RuntimeError):
        benchmarks.make_setup(32, 4)
    with pytest.raises(RuntimeError):
        benchmarks.bench_nde_forward(8, n_steps=1, repeats=1)
    with pytest.raises(RuntimeError):
        checkpoint.load_flux_nns(str(REPO / "runs" / "wm_flagship_fold"))
    with pytest.raises(RuntimeError):
        from_reference(1.0)
    model, nns, bcs, _ = benchmarks.make_setup(32, 4, device="cpu")
    for make in (fused_rhs.make_fused_runner_mxu, fused_rhs.make_fused_runner):
        with pytest.raises(RuntimeError):
            make(model, nns, bcs, 1e-5, 1, 4)
    with pytest.raises(RuntimeError):
        fused_rhs.make_fast_rhs(model, nns, bcs)


@pytest.mark.parametrize("make", [
    lambda: mlp.mlp_init(torch.Generator().manual_seed(0), (4, 4)),
    lambda: mlp.wind_mixing_mlp(torch.Generator().manual_seed(0), 8),
    lambda: MPPParameters.default(),
], ids=["mlp_init", "wind_mixing_mlp", "MPPParameters.default"])
def test_constructors_raise_without_card(no_card, make):
    # Public constructors follow the entry points: cuda unless asked, never a quiet CPU.
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make()


@pytest.mark.parametrize("bench", [
    lambda: benchmarks.bench_nde_forward(8, n_steps=1, repeats=1, device="cpu"),
    lambda: benchmarks.bench_train_step({}, device="cpu"),
    lambda: benchmarks.bench_tridiagonal(8, 4, device="cpu"),
    lambda: benchmarks.bench_nde_train_step(2, n_window=2, method="rk4", device="cpu"),
], ids=["bench_nde_forward", "bench_train_step", "bench_tridiagonal", "bench_nde_train_step"])
def test_bench_refuses_cpu(bench):
    with pytest.raises(RuntimeError, match="card"):
        bench()


def test_training_entry_points_raise_without_card(no_card):
    from climateparameterizations_jl_tpu_torch.cli.main import _load_suite

    with pytest.raises(RuntimeError, match="device='cpu'"):
        benchmarks.flagship_train_setup()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _load_suite(["wind_-5e-4_new"], 8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        benchmarks.bench_tridiagonal(8, 4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        benchmarks.nde_train_step_setup(2, n_window=2)

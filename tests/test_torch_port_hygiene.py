"""The port stands alone: no JAX, no JAX package, and no silent CPU fallback."""

import ast
from pathlib import Path

import pytest
import torch

import climateparameterizations_jl_tpu_torch as port
from climateparameterizations_jl_tpu_torch import benchmarks
from climateparameterizations_jl_tpu_torch.bridge import from_reference
from climateparameterizations_jl_tpu_torch.closures import mlp
from climateparameterizations_jl_tpu_torch.data.les import LESConfig
from climateparameterizations_jl_tpu_torch.embed.double_gyre import DoubleGyreModel
from climateparameterizations_jl_tpu_torch.ops import fused_rhs
from climateparameterizations_jl_tpu_torch.physics.mpp import MPPParameters
from climateparameterizations_jl_tpu_torch.train import checkpoint

REPO = Path(__file__).resolve().parents[1]
SCRIPTS = [REPO / name for name in ("chip_smoke.py", "bench_turns.py", "fused_rk4_phases.py", "gram_phases.py",
                                    "embedded_stored_truth.py")]
PORT_FILES = sorted((REPO / "climateparameterizations_jl_tpu_torch").rglob("*.py")) + SCRIPTS
# The repo's studies/ scripts are JAX programs: the port keeps its own copies (climateparameterizations_jl_tpu_torch/
# studies/), whose top-level name is the port's.
FORBIDDEN = {"jax", "jaxlib", "climateparameterizations_jl_tpu", "studies"}


def _top_level_imports(path):
    return _imports(ast.parse(path.read_text(), str(path)))


def _module_level_imports(path):
    """Imports run when the module is imported: outside any function or class body."""
    tree = ast.parse(path.read_text(), str(path))
    return [name for node in tree.body if not isinstance(node, (ast.FunctionDef, ast.ClassDef))
            for name in _imports(node)]


def _imports(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_port_files_found():
    assert len(PORT_FILES) > 15
    names = {str(p.relative_to(REPO / "climateparameterizations_jl_tpu_torch")) for p in PORT_FILES[:-len(SCRIPTS)]}
    assert {"cli/__main__.py", "cli/main.py", "closures/gp.py", "models/gp_closure.py", "ops/gram.py",
            "ops/cholesky.py", "core/convective_adjust.py", "physics/convective_adjustment.py",
            "models/free_convection.py", "data/lesbrary.py", "data/netcdf.py", "data/flux_reconstruction.py",
            "data/free_convection.py", "train/nn.py", "embed/column_model.py", "embed/double_gyre.py",
            "train/embedded.py", "core/advection.py", "data/les.py", "parallel/__init__.py",
            "parallel/sharding.py", "eval/animations.py", "eval/report.py", "utils/__init__.py",
            "utils/polynomial.py", "utils/predict.py", "utils/profiling.py", "studies/__init__.py",
            "studies/flagship_training.py", "studies/adjoint_parity.py", "studies/forward_scaling.py",
            "studies/fused_kernel_sweep.py", "studies/fc_fair_substep_check.py", "studies/gp_at_scale.py"} <= names


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_imports(path):
    # Whole names: climateparameterizations_jl_tpu_torch begins with a forbidden one.
    bad = set(_top_level_imports(path)) & FORBIDDEN
    assert not bad, f"{path} imports {sorted(bad)}"


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_module_level_h5py_import(path):
    # A GPU host may have no h5py: port modules import it inside the functions that read or write files.
    assert "h5py" not in _module_level_imports(path), f"{path} imports h5py when it is imported"


def test_h5py_scan_catches_module_level_import(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("def g():\n    import h5py\n")
    assert _module_level_imports(f) == []
    f.write_text("try:\n    import h5py\nexcept ImportError:\n    pass\n")
    assert _module_level_imports(f) == ["h5py"]


def test_scan_catches_forbidden_import(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import climateparameterizations_jl_tpu_torch\nfrom climateparameterizations_jl_tpu.ops import x\n")
    assert set(_top_level_imports(f)) & FORBIDDEN == {"climateparameterizations_jl_tpu"}


@pytest.mark.parametrize("source,found", [
    ("from studies.flagship_training import STAGES\n", {"studies"}),
    ("def f():\n    import studies.adjoint_parity\n", {"studies"}),
    ("from climateparameterizations_jl_tpu_torch.studies import flagship_training\n", set()),
])
def test_scan_refuses_the_repo_studies_package(tmp_path, source, found):
    f = tmp_path / "m.py"
    f.write_text(source)
    assert set(_top_level_imports(f)) & FORBIDDEN == found


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
    from climateparameterizations_jl_tpu_torch.cli.main import main

    for argv in (["generate-les", "--n-horizontal", "8", "--nz-les", "8", "--n-save", "1"],
                 ["ensemble", "--nz", "8", "--n-save", "4", "--n-members", "2", "--n-steps", "2"]):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            main([*argv, "--output", "/nonexistent/out"])


@pytest.mark.parametrize("make", [
    lambda: mlp.mlp_init(torch.Generator().manual_seed(0), (4, 4)),
    lambda: mlp.wind_mixing_mlp(torch.Generator().manual_seed(0), 8),
    lambda: MPPParameters.default(),
    lambda: DoubleGyreModel.default(8, 8, 4),
    lambda: LESConfig.default(8, 8, 4),
], ids=["mlp_init", "wind_mixing_mlp", "MPPParameters.default", "DoubleGyreModel.default", "LESConfig.default"])
def test_constructors_raise_without_card(no_card, make):
    # Public constructors follow the entry points: cuda unless asked, never a quiet CPU.
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make()


@pytest.mark.parametrize("bench", [
    lambda: benchmarks.bench_nde_forward(8, n_steps=1, repeats=1, device="cpu"),
    lambda: benchmarks.bench_train_step({}, device="cpu"),
    lambda: benchmarks.bench_tridiagonal(8, 4, device="cpu"),
    lambda: benchmarks.bench_nde_train_step(2, n_window=2, method="rk4", device="cpu"),
    lambda: benchmarks.bench_fc_forward(8, 8, 2, repeats=1, device="cpu"),
    lambda: benchmarks.profile_fc_forward(8, 8, 2, device="cpu"),
    lambda: benchmarks.bench_host_column(4, 8, 1, 1, device="cpu"),
    lambda: benchmarks.profile_host_column(4, 8, 1, 1, device="cpu"),
    lambda: benchmarks.bench_double_gyre(8, 8, 4, 1, repeats=1, device="cpu"),
    lambda: benchmarks.profile_double_gyre(8, 8, 4, 1, device="cpu"),
    lambda: benchmarks.bench_les(8, 8, 1, repeats=1, device="cpu"),
    lambda: benchmarks.bench_column_ensemble(8, 8, 2, repeats=1, device="cpu"),
    lambda: benchmarks.run_suite(quick=True, device="cpu"),
    lambda: benchmarks.headline(n_timed=1, n_repeats=1, device="cpu"),
], ids=["bench_nde_forward", "bench_train_step", "bench_tridiagonal", "bench_nde_train_step", "bench_fc_forward",
        "profile_fc_forward", "bench_host_column", "profile_host_column", "bench_double_gyre", "profile_double_gyre",
        "bench_les", "bench_column_ensemble", "run_suite", "headline"])
def test_bench_refuses_cpu(bench):
    with pytest.raises(RuntimeError, match="card"):
        bench()


def test_training_entry_points_raise_without_card(no_card):
    from climateparameterizations_jl_tpu_torch.cli.main import _load_fc_suite, _load_suite

    with pytest.raises(RuntimeError, match="device='cpu'"):
        benchmarks.flagship_train_setup()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _load_suite(["wind_-5e-4_new"], 8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        benchmarks.bench_tridiagonal(8, 4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        benchmarks.nde_train_step_setup(2, n_window=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        benchmarks.fc_forward_setup(8, 8, 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _load_fc_suite([1], 8, n_save=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        benchmarks.host_column_setup(4, 8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        benchmarks.double_gyre_setup(8, 8, 4)


@pytest.mark.parametrize("argv", [
    ["train-embedded", "--sims", "strong_wind", "--nz", "8", "--n-save", "4"],
    ["train-embedded-fc", "--sim-ids", "1", "--nz", "8", "--n-save", "4"],
    ["evaluate", "--embedded", "--checkpoint", str(REPO / "runs" / "wm_flagship_fold")],
    ["evaluate-fc", "--embedded", "--checkpoint", str(REPO / "runs" / "fc_flagship")],
    ["double-gyre", "--nx", "8", "--ny", "8", "--nz-gyre", "4", "--days", "0.1"],
    ["generate-les", "--n-horizontal", "8", "--nz-les", "8", "--n-save", "1"],
    ["ensemble", "--nz", "8", "--n-save", "4", "--n-members", "2", "--n-steps", "2"],
    ["train-fc-nde", "--sim-ids", "1", "--nz", "8", "--n-save", "1", "--source", "les3d"],
], ids=["train-embedded", "train-embedded-fc", "evaluate --embedded", "evaluate-fc --embedded", "double-gyre",
        "generate-les", "ensemble", "train-fc-nde --source les3d"])
def test_commands_raise_without_card(no_card, argv, tmp_path):
    # The commands run on the card unless --device cpu is given: without one they raise before any work.
    from climateparameterizations_jl_tpu_torch.cli.main import main

    with pytest.raises(RuntimeError, match="device='cpu'"):
        main([*argv, "--output", str(tmp_path / "out")])


def test_matplotlib_stays_off_the_import_path():
    """Only the figures module imports matplotlib (the card's machine has none): the package, the CLI, the
    benchmarks, the report and the utilities import without it."""
    import subprocess
    import sys

    code = ("import sys; sys.modules['matplotlib'] = None\n"
            "import climateparameterizations_jl_tpu_torch.cli.main, climateparameterizations_jl_tpu_torch.benchmarks\n"
            "import climateparameterizations_jl_tpu_torch.eval as e, climateparameterizations_jl_tpu_torch.utils\n"
            "assert e.training_report and e.report.animations_or_none() is None\n")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO)


def test_studies_raise_without_card(no_card, tmp_path):
    """The studies run on the card unless --device cpu is given: without one they raise before any work."""
    from climateparameterizations_jl_tpu_torch.studies import adjoint_parity, flagship_training

    for argv in (["--eval-checkpoint", str(REPO / "runs" / "wm_flagship_fold")], ["--mode", "step-bench"]):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            flagship_training.main(argv)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        adjoint_parity.main(["--out", str(tmp_path / "ap.json")])
    assert not (tmp_path / "ap.json").exists()
    from climateparameterizations_jl_tpu_torch.studies import (
        fc_fair_substep_check,
        forward_scaling,
        fused_kernel_sweep,
        gp_at_scale,
    )

    for name, main, argv in (
            ("fs.jsonl", forward_scaling.main, ["--columns", "8", "--n-steps", "4"]),
            ("sweep.jsonl", fused_kernel_sweep.main, ["--quick"]),
            ("fair.npy", fc_fair_substep_check.main, []),
            ("gp.json", gp_at_scale.main, ["--smoke"]),
            ("gram.json", gp_at_scale.main, ["--gram-only", "--smoke"])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            main([*argv, "--out", str(tmp_path / name)])
        assert not (tmp_path / name).exists()

"""Rules of the PyTorch port: it imports neither JAX nor the reference
package, its copies of the framework-neutral modules stay textually equal
to the originals up to the package name, and its entry points run on the
card unless told otherwise -- raising, not falling back, without one."""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch
from test_torch_examples import port_example

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro", "ml_dtypes")

COPIED = [
    "core/cost_model.py", "core/scheduler.py", "core/churn.py",
    "core/executor.py", "core/gemm_dag.py", "core/verify.py",
    "core/seeding.py", "core/tail.py", "core/streaming.py",
    "core/dataflow.py", "core/analysis.py", "core/bandit.py",
    "sim/engine.py", "sim/events.py", "sim/devices.py",
    "sim/baselines.py", "sim/engine_array.py",
    "api/fleet.py", "api/accounting.py", "api/mitigation.py",
    "serving/batcher.py", "serving/loadgen.py", "train_loop/hook.py",
] + sorted(f"configs/{p.name}"
           for p in (ROOT / "src" / "repro" / "configs").glob("*.py"))


# modules the port copies in part: these top-level definitions stay equal
# to the reference's (up to the package name); the rest of each module is
# the port's own
COPIED_DEFS = {
    "api/ps_group.py": ["ShardedFleet"],
    "api/runtime.py": ["StreamReport"],
    "checkpointing/checkpoint.py": ["_flatten", "load_metadata",
                                    "CheckpointManager"],
    "data/pipeline.py": ["DataConfig", "SyntheticLM"],
    "optim/diloco.py": ["DiLoCoConfig", "OuterState", "ParamPartition",
                        "communication_per_round", "sync_traffic"],
    # all but _cleave (the port's runtime, built on the host) and
    # cleave_batch_time (its message names the port's runtime)
    "sim/simulator.py": ["CleaveResult", "compare_systems",
                         "straggler_experiment", "churn_experiment",
                         "scaling_devices", "scaling_model",
                         "scaling_batch", "ablation",
                         "adaptive_experiment", "_evaluate_on",
                         "memory_experiment"],
    "train_loop/multi_ps.py": ["MultiPSState", "MultiPSStepReport",
                               "_Island"],
    "train_loop/train_step.py": ["FleetStepReport", "PS_LOCAL_GEMMS",
                                 "fleet_lowered", "price_request",
                                 "price_trace_emulated"],
}


def _top_level_defs(path: Path) -> dict:
    text = path.read_text()
    out = {}
    for node in ast.parse(text).body:
        names = [getattr(node, "name", None)] + [
            t.id for t in getattr(node, "targets", []) if hasattr(t, "id")]
        for name in names:
            if name:
                out[name] = ast.get_source_segment(text, node)
    return out


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


EXAMPLES = ROOT / "examples_torch"


def test_port_imports_neither_jax_nor_reference():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"] \
        + sorted(EXAMPLES.glob("*.py"))
    assert len(files) > 30
    bad = [(str(f.relative_to(ROOT)), mod) for f in files
           for mod in _imports(f)
           if mod.split(".")[0] in FORBIDDEN]
    assert not bad, bad


# the mesh layer: rewrites of reference modules that import JAX
MESH_MODULES = ("parallel/__init__.py", "parallel/sharding.py",
                "parallel/spmd.py", "launch/mesh.py", "launch/specs.py",
                "launch/steps.py", "launch/cost_analysis.py",
                "launch/dryrun.py", "launch/mesh_check.py")


@pytest.mark.parametrize("rel", MESH_MODULES)
def test_mesh_modules_import_neither_jax_nor_reference(rel):
    path = PORT / rel
    assert path.exists()
    bad = [mod for mod in _imports(path) if mod.split(".")[0] in FORBIDDEN]
    assert not bad, bad


def test_mesh_entry_points_raise_without_cuda():
    """The dry run and the mesh check default to the card and raise
    before they start a process group or a rank."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    from repro_torch.launch import dryrun, mesh_check
    with pytest.raises(RuntimeError, match="cuda"):
        dryrun.main(["--arch", "llama3-8b", "--shape", "decode_32k"])
    with pytest.raises(RuntimeError, match="cuda"):
        mesh_check.main(["--arch", "llama3-8b"])


@pytest.mark.parametrize("rel", COPIED)
def test_copied_module_equals_original(rel):
    original = (ROOT / "src" / "repro" / rel).read_text()
    assert (PORT / rel).read_text() == original.replace("repro.",
                                                        "repro_torch.")


@pytest.mark.parametrize("rel,name", [(rel, name)
                                      for rel, names in COPIED_DEFS.items()
                                      for name in names])
def test_copied_definition_equals_original(rel, name):
    original = _top_level_defs(ROOT / "src" / "repro" / rel)[name]
    ours = _top_level_defs(PORT / rel)[name]
    assert ours == original.replace("repro.", "repro_torch.")


def test_training_entry_points_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    from repro_torch.launch import profile_train, train
    with pytest.raises(RuntimeError, match="cuda"):
        train.main(["--reduced", "--steps", "1", "--batch", "1",
                    "--seq", "8"])
    with pytest.raises(RuntimeError, match="cuda"):
        profile_train.main(["--layers", "1", "--steps", "1"])


def test_default_device_entry_points_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    from repro_torch.api import Fleet, TorchCleaveRuntime
    from repro_torch.launch import serve
    with pytest.raises(RuntimeError, match="cuda"):
        TorchCleaveRuntime(arch="llama3-8b", fleet=Fleet.sample(4, seed=0))
    with pytest.raises(RuntimeError, match="cuda"):
        serve.main(["--batch", "1", "--gen", "2"])
    # a multi-PS session: its islands' runtimes take the template's
    # device, so a default-device session raises too
    from repro_torch.api import PSGroup
    from repro_torch.train_loop import MultiPSTrainSession
    with pytest.raises(RuntimeError, match="cuda"):
        TorchCleaveRuntime(arch="llama3-8b", fleet=Fleet.sample(8, seed=0)
                           ).train_session(n_ps=2)
    cpu = TorchCleaveRuntime(arch="llama3-8b", fleet=Fleet.sample(8, seed=0),
                             device="cpu")
    cpu.device = torch.device("cuda")      # a card template, as it would be
    with pytest.raises(RuntimeError, match="cuda"):
        MultiPSTrainSession(cpu, n_ps=2)
    with pytest.raises(RuntimeError, match="cuda"):
        PSGroup(ps_id=0, fleet=Fleet.sample(4, seed=0)).runtime_for(cpu)
    # every ported example, before it draws or plans anything
    names = sorted(p.stem for p in EXAMPLES.glob("*.py"))
    assert len(names) == 8
    for name in names:
        with pytest.raises(RuntimeError, match="cuda"):
            port_example(name).main([])


def _run_smoke(cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=120)


def test_chip_smoke_fails_without_card_or_repo(tmp_path):
    """chip_smoke.py exits non-zero and prints no result line on a host
    without CUDA, and in a directory holding nothing else of the repo."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    res = _run_smoke(ROOT)
    assert res.returncode != 0 and '"ok"' not in res.stdout
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    res = _run_smoke(tmp_path)
    assert res.returncode != 0 and '"ok"' not in res.stdout

"""The port imports torch, never jax and nothing of the reference package."""
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro\b(?!_)|from\s+repro[.\s])",
    re.MULTILINE)


def _port_sources():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    return files


def test_port_sources_exist():
    names = {p.name for p in _port_sources()}
    assert {"flash_attention.py", "kv_pool.py", "tenant.py", "serve.py",
            "chip_smoke.py", "stream_matmul.py", "runtime.py",
            "partitioner.py", "perfmodel.py", "power.py", "roofline.py",
            "workload.py", "slice_runtime_demo.py", "adamw.py",
            "train_step.py", "checkpoint.py", "fault.py", "pipeline.py",
            "train.py", "train_gpt2.py", "ssm.py", "ssd_scan.py", "moe.py",
            "grouped_matmul.py", "scheduler.py", "actions.py", "placement.py",
            "trace.py", "cosched.py", "reward.py", "utilization.py",
            "autoscale.py", "loadgen.py", "planner.py", "metrics.py",
            "cluster.py", "step_analysis.py", "dryrun.py", "quickstart.py",
            "offload_serving.py", "multi_tenant_sharing.py", "cluster_sim.py",
            "autoscale_demo.py", "mesh.py"} <= names
    assert all(p.exists() for p in _port_sources())


def test_no_jax_or_reference_import_in_port_sources():
    bad = []
    for path in _port_sources():
        for m in FORBIDDEN.finditer(path.read_text()):
            bad.append(f"{path.relative_to(ROOT)}: {m.group(0).strip()}")
    assert not bad, bad


def test_forbidden_pattern_catches_what_it_should():
    for line in ("import jax", "from jax import numpy", "import repro",
                 "from repro.core import hw", "from repro import core",
                 "    import jax.numpy as jnp", "import repro.configs"):
        assert FORBIDDEN.search(line), line
    for line in ("import repro_torch", "from repro_torch.core import hw",
                 "# import jax", "x = 'from jax'"):
        assert not FORBIDDEN.search(line), line


def test_import_port_leaves_jax_out():
    code = (
        "import sys, pkgutil, importlib\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [n for n in sys.modules if n == 'jax' or n.startswith('jax.')\n"
        "       or n == 'repro' or n.startswith('repro.')]\n"
        "assert not bad, bad\n"
        "print('clean', len([n for n in sys.modules if n.startswith('repro_torch')]))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT,
                         env={"PYTHONPATH": str(ROOT / "src"), "PATH": ""})
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("clean")


def test_mesh_module_imports_without_jax_and_builds_nothing():
    """``repro_torch.launch.mesh`` imports without jax and, like the
    reference's, touches no device state at import: no process group runs
    and no mesh is built until a factory is called."""
    code = (
        "import sys\n"
        "import torch.distributed as dist\n"
        "import repro_torch.launch.mesh as m\n"
        "assert not dist.is_initialized()\n"
        "assert not m.is_fake_world()\n"
        "assert not any(n == 'jax' or n.startswith('jax.') for n in sys.modules)\n"
        "with m.fake_world(4):\n"
        "    mesh = m.make_host_mesh(2, 2)\n"
        "    assert m.is_fake_world() and tuple(mesh.shape) == (2, 2)\n"
        "assert not dist.is_initialized()\n"
        "print('clean')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT,
                         env={"PYTHONPATH": str(ROOT / "src"), "PATH": ""})
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("clean")

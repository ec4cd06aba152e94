"""The helpers of ``chip_smoke.py`` and its refusal to run without a card.

The script itself needs an H100; here only what it computes on the host (the
host link's peak rate, from which stream_matmul's bound is taken) and its
exit without CUDA are checked."""
import importlib.util
import os
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(ROOT, "chip_smoke.py")


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("gen,width,gb_per_s", [
    (1, 16, 4.0), (2, 16, 8.0), (3, 16, 15.753846), (4, 16, 31.507692),
    (5, 16, 63.015385), (5, 8, 31.507692), (4, 1, 1.969231)])
def test_pcie_peak_rate(gen, width, gb_per_s):
    """Lanes x GT/s x line code / 8: Gen5 x16 carries 63.0 GB/s one way."""
    assert _chip_smoke().pcie_peak_bytes_per_s(gen, width) / 1e9 == \
        pytest.approx(gb_per_s, rel=1e-6)


@pytest.mark.parametrize("gen,width", [(0, 16), (7, 16), (5, 0)])
def test_pcie_peak_rate_rejects_unknown_links(gen, width):
    with pytest.raises(ValueError):
        _chip_smoke().pcie_peak_bytes_per_s(gen, width)


def test_exits_without_cuda_and_prints_no_result(capsys, monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        _chip_smoke().main()
    assert exc.value.code != 0
    assert capsys.readouterr().out == ""


def test_fails_alone_in_a_directory(tmp_path):
    """Copied into a directory that holds nothing else of the repo, the
    script exits non-zero and prints no result."""
    shutil.copy(SCRIPT, tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    run = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=env, capture_output=True, text=True, timeout=300)
    assert run.returncode != 0
    assert '"ok": true' not in run.stdout

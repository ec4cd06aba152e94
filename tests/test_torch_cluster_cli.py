"""The port's cluster CLI (``repro_torch.launch.cluster``) against the
reference's (``repro.launch.cluster``): the same flags print the same header,
job table and metrics table, character for character. Modelled runs pass
``--no-execute``; the live CSV replay runs the port's tenants on the CPU
(``--device cpu``) beside the reference's."""
import os
import sys

import pytest

from repro.launch import cluster as ref_cli
from repro_torch.launch import cluster as port_cli

FIXTURE = os.path.join(os.path.dirname(__file__), "data", "philly_mini.csv")

SHOWCASES = ("--showcase", "--elastic-showcase", "--preemption-showcase",
             "--grow-showcase", "--migration-showcase", "--lookahead-showcase",
             "--search-showcase", "--twin-showcase", "--reconfigure-showcase")


def _run(cli, argv, capsys, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["cluster", *argv])
    cli.main()
    return capsys.readouterr().out


def _same(argv, capsys, monkeypatch, port_extra=()):
    want = _run(ref_cli, argv, capsys, monkeypatch)
    got = _run(port_cli, [*argv, *port_extra], capsys, monkeypatch)
    assert got == want
    return got


@pytest.mark.parametrize("flag", SHOWCASES)
def test_showcase_tables_equal_reference(flag, capsys, monkeypatch):
    out = _same([flag, "--no-execute"], capsys, monkeypatch)
    assert out.startswith("# placement=") and "\njob  " in out


def test_twin_showcase_with_twin_pricing_equals_reference(capsys, monkeypatch):
    out = _same(["--twin-showcase", "--twin", "--no-execute"], capsys,
                monkeypatch)
    assert "+cpu" in out


@pytest.mark.parametrize("argv", [
    ["--pods", "2", "--trace-seed", "0", "--no-execute"],
    ["--pods", "1", "--jobs", "30", "--trace-seed", "5", "--no-execute",
     "--actions", "shrink,preempt,grow", "--policy", "lookahead"],
    ["--pods", "1", "--jobs", "30", "--frozen-durations", "--no-execute"],
    ["--trace-csv", FIXTURE, "--pods", "1", "--no-execute"],
    ["--trace-csv", FIXTURE, "--pods", "1", "--chip", "mi300",
     "--no-execute"],
    ["--autoscale", "--day", "14400"],
    ["--load-curve", "bursty", "--day", "14400", "--tenants", "1"],
    ["--modes", "--chip", "mi300"],
], ids=["trace0-2pods", "lookahead-actions", "frozen", "csv-v5e", "csv-mi300",
        "autoscale", "load-curve", "modes"])
def test_modelled_runs_equal_reference(argv, capsys, monkeypatch):
    _same(argv, capsys, monkeypatch)


def test_live_csv_replay_on_cpu_equals_reference(capsys, monkeypatch):
    """The CSV replay with its serving jobs executed: the reference's tenants
    on its host backend, the port's at ``--device cpu``; the tokens column
    shows each one's decoded tokens."""
    out = _same(["--trace-csv", FIXTURE, "--pods", "1"], capsys, monkeypatch,
                port_extra=["--device", "cpu"])
    assert "live_serving_tenants=2" in out


def test_full_size_and_attn_impl_flags_reach_the_serving_config(monkeypatch):
    """``--full-size --attn-impl pallas`` give live tenants the published
    widths in bf16 weights with the flash kernel's prefill; without them
    the reference's reduced config."""
    seen = {}

    class Recorder:
        def __init__(self, **kw):
            seen.update(kw)

        def run(self, jobs):
            raise SystemExit(0)
    monkeypatch.setattr(port_cli, "ClusterScheduler", Recorder)
    for extra in ([], ["--full-size", "--attn-impl", "pallas"]):
        monkeypatch.setattr(sys, "argv", ["cluster", "--showcase", *extra])
        with pytest.raises(SystemExit):
            port_cli.main()
        cfg = seen["serving_config"]("phi3-mini-3.8b")
        assert seen["device"] == "cuda"
        if extra:
            assert (cfg.num_layers, cfg.head_dim, cfg.param_dtype,
                    cfg.attn_impl) == (32, 96, "bfloat16", "pallas")
        else:
            from repro_torch.configs import tenant_config
            assert cfg == tenant_config("phi3-mini-3.8b")

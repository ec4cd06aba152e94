"""The port's examples (``repro_torch.examples``) run on the CPU, and the pure-
Python ones print the reference examples' text."""
import importlib.util
import pathlib
import re

import pytest

from repro_torch.examples import (autoscale_demo, cluster_sim,
                                  multi_tenant_sharing, offload_serving,
                                  quickstart)

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _reference_example(name):
    spec = importlib.util.spec_from_file_location(
        f"reference_example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _printed(capsys, fn, *args):
    capsys.readouterr()
    fn(*args)
    return capsys.readouterr().out


@pytest.mark.parametrize("port,name", [(multi_tenant_sharing, "multi_tenant_sharing"),
                                       (autoscale_demo, "autoscale_demo")])
def test_pure_python_example_prints_the_reference_text(capsys, port, name):
    want = _printed(capsys, _reference_example(name).main)
    got = _printed(capsys, port.main)
    assert got == want
    assert len(got.splitlines()) > 10


class _LiveSection(Exception):
    pass


def test_cluster_sim_showcases_print_the_reference_text(capsys, monkeypatch):
    """The six showcases against the reference example's text up to its live
    section (stopped there: the reference's live trace takes ~22 s here)."""
    ref = _reference_example("cluster_sim")

    def stop(*_, **__):
        raise _LiveSection
    monkeypatch.setattr(ref, "generate_trace", stop)
    capsys.readouterr()
    with pytest.raises(_LiveSection):
        ref.main()
    want = capsys.readouterr().out
    want = want[:want.index("\n=== seeded mixed trace")]
    got = _printed(capsys, cluster_sim.showcases)
    assert got.rstrip("\n") == want.rstrip("\n")
    assert "SLO HIT" in got and "QUEUED at horizon" in got


def test_cluster_sim_live_trace_on_the_cpu(capsys):
    out = _printed(capsys, cluster_sim.live_trace, "cpu")
    served = re.findall(r"serving .* tokens=(\d+)", out)
    assert served and all(int(t) > 0 for t in served)
    assert "jobs placed/completed/queued" in out


def test_quickstart_trains_and_serves_on_the_cpu(capsys):
    out = _printed(capsys, quickstart.main, ["--device", "cpu"])
    losses = [float(x) for x in re.findall(r"loss (\d+\.\d+)", out)]
    assert losses[-1] < losses[0]
    assert len(re.findall(r"request \d: generated \[", out)) == 2


def test_offload_serving_gives_identical_tokens_on_the_cpu(capsys):
    out = _printed(capsys, offload_serving.main, ["--device", "cpu"])
    assert "outputs identical with and without KV offloading" in out
    assert re.search(r"offload_kv=True .*host_bytes=[1-9]", out)

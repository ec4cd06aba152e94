"""The port's measured dry run (``repro_torch.launch.dryrun``) on the CPU at the
reduced size: its records load through both packages' ``load_anchors`` and
calibrate ``PerfModel.from_artifacts``; ``k`` parts count what the whole
batch counts at once; a cell too big for its device budget is skipped with
its bytes; ``--mesh multi`` and ``both`` write one device's shard of the
reference's meshes (``tests/test_torch_mesh_dryrun.py`` holds them).

The reference's ``repro.launch.dryrun`` is never imported here: its first
lines set ``XLA_FLAGS`` for 512 host devices."""
import json
import math
import os

import pytest

from repro.core import perfmodel as ref_pm
from repro_torch.configs import get_config, get_shape
from repro_torch.core import perfmodel as port_pm
from repro_torch.core.slices import PROFILES
from repro_torch.launch import dryrun

CELLS = [("gpt2-124m", "train_4k"), ("llama3-8b", "prefill_32k"),
         ("gpt2-124m", "decode_32k"), ("mamba2-130m", "long_500k")]


def _run(tmp_path, arch, shape, *extra):
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", arch, "--shape", shape, "--reduced",
                     "--device", "cpu", "--out", str(tmp_path), *extra])
    return e.value.code


def _calibrated(model, arch, shape):
    cfg, shp = get_config(arch), get_shape(shape)
    for prof in PROFILES:
        sc = model.score(cfg, shp, prof)
        if sc is not None:
            return sc.calibrated
    raise AssertionError(f"no profile fits {arch} {shape}")


@pytest.mark.parametrize("arch,shape", CELLS)
def test_record_loads_and_calibrates(tmp_path, arch, shape):
    assert _run(tmp_path, arch, shape) == 0
    path = tmp_path / "single" / f"{arch}__{shape}.json"
    rec = json.loads(path.read_text())
    assert rec["ran"] and rec["roofline"]["n_chips"] == 1
    r = rec["roofline"]
    assert r["hlo_flops_per_chip"] > 0 and r["hlo_bytes_per_chip"] > 0
    m = rec["measured"]
    assert m["device"] == "cpu" and m["mfu"] is None
    assert m["part_ms_min"] <= m["part_ms_median"] <= m["part_ms_max"]
    assert m["step_ms"] >= m["k"] * m["part_ms_median"]
    for anchors in (port_pm.load_anchors(str(tmp_path)),
                    ref_pm.load_anchors(str(tmp_path))):
        a = anchors[(arch, shape)]
        assert (a.n_chips, a.hlo_flops_per_chip, a.hlo_bytes_per_chip,
                a.step_time_s) == (1, r["hlo_flops_per_chip"],
                                   r["hlo_bytes_per_chip"], r["step_time_s"])
    assert _calibrated(port_pm.PerfModel.from_artifacts(str(tmp_path)),
                       arch, shape)
    assert not _calibrated(port_pm.PerfModel(), arch, shape)


@pytest.mark.parametrize("arch,shape", CELLS[:3])
def test_parts_combined_equal_the_whole_batch(arch, shape):
    """At a global batch of 2 (the reduced shape), two parts of one sequence
    count the products of the whole batch counted at once. Bytes differ: each
    part reads the weights again."""
    whole = dryrun.measure_cell(arch, shape, device="cpu", reduced=True,
                                overrides={"microbatches": 1}, iters=1)
    parts = dryrun.measure_cell(arch, shape, device="cpu", reduced=True,
                                overrides={"microbatches": 2}, iters=1)
    assert whole["global_batch"] == parts["global_batch"] == 2
    assert (whole["measured"]["k"], parts["measured"]["k"]) == (1, 2)
    wf = whole["roofline"]["hlo_flops_per_chip"]
    pf = parts["roofline"]["hlo_flops_per_chip"]
    assert pf == pytest.approx(wf, rel=1e-12)
    assert parts["roofline"]["model_flops"] == whole["roofline"]["model_flops"]


def test_training_loss_is_recorded_and_nan_past_learned_positions():
    """A training record holds the part's loss: finite where the sequence
    fits the learned position table, NaN and noted as such where it runs
    past it (as gpt2-124m's 4,096 tokens pass its 1,024 positions)."""
    rec = dryrun.measure_cell("gpt2-124m", "train_4k", device="cpu",
                              reduced=True, iters=1)
    assert math.isfinite(rec["loss"]) and "loss_note" not in rec
    short = rec["seq_len"] // 2
    rec = dryrun.measure_cell("gpt2-124m", "train_4k", device="cpu",
                              reduced=True, overrides={"max_position": short},
                              iters=1)
    assert math.isnan(rec["loss"]) and f"the {short} learned" in rec["loss_note"]
    assert all(math.isfinite(v) for v in rec["measured"].values()
               if isinstance(v, float))


def test_cell_over_the_device_budget_is_skipped_with_its_bytes():
    rec = dryrun.measure_cell("llama3-8b", "train_4k", device="cpu",
                              reduced=True, budget_bytes=1000)
    assert "exceeds" in rec["skipped"]
    res = rec["resident_bytes"]
    assert res["total"] == res["params"] + res["grads"] + res["moments"] > 1000
    assert res["moments"] == 2 * res["params"]       # fp32 params, fp32 moments
    rec = dryrun.measure_cell("llama3-8b", "decode_32k", device="cpu",
                              reduced=True, budget_bytes=1000)
    assert rec["resident_bytes"]["cache_one_sequence"] > 0 and rec["skipped"]
    # the reference's applicability skips stay
    rec = dryrun.measure_cell("llama3-8b", "long_500k", device="cpu",
                              reduced=True)
    assert "quadratic" in rec["skipped"]


def test_resident_state_at_full_size_decides_the_expected_skips():
    """At full size, on an 80 GiB card: the resident state alone rules out
    training the 7B+ archs and serving the two largest (no memory is
    allocated: the parameters are meta tensors)."""
    from repro_torch.models.model_zoo import build_model
    budget = 80 * 1024 ** 3

    def over(arch, shape):
        shp = get_shape(shape)
        cfg = dryrun.cell_config(arch, shp)
        return dryrun.resident_bytes(build_model(cfg, "cpu"), shp)["total"] > budget
    for arch in ("llama3-8b", "starcoder2-7b", "qwen3-32b", "command-r-35b",
                 "qwen2-vl-72b", "phi3.5-moe-42b-a6.6b"):
        assert over(arch, "train_4k"), arch
    for arch in ("gpt2-124m", "granite-moe-1b-a400m", "mamba2-130m",
                 "zamba2-1.2b", "phi3-mini-3.8b"):
        assert not over(arch, "train_4k"), arch
    for shape in ("prefill_32k", "decode_32k"):
        assert over("phi3.5-moe-42b-a6.6b", shape)
        assert over("qwen2-vl-72b", shape)
        assert not over("qwen3-32b", shape) and not over("llama3-8b", shape)


def test_parts_chosen_by_the_estimate():
    assert dryrun.choose_parts(256, 10, None) == 1
    assert dryrun.choose_parts(256, 10, 1e9) == 1
    assert dryrun.choose_parts(256, 1e9, 100e9) == 8      # 32 x 1 GB <= 60 GB
    assert dryrun.choose_parts(32, 1e12, 1e9) == 32        # one sequence a part


def test_failure_is_an_error_record_and_mesh_multi_exits(tmp_path):
    """A failing cell is an error record no anchor reads; ``--mesh multi``
    and ``both`` (the reference's meshes, one device's shard under a fake
    world) now write records and exit 0."""
    rec = dryrun.run_cell("gpt2-124m", "train_4k", str(tmp_path),
                          overrides={"microbatches": 3}, device="cpu",
                          reduced=True)
    assert "does not split" in rec["error"]
    assert os.path.exists(tmp_path / "gpt2-124m__train_4k.json")
    assert port_pm.load_anchors(str(tmp_path.parent), tmp_path.name) == {}
    out = tmp_path / "meshes"
    assert _run(out, "gpt2-124m", "decode_32k", "--mesh", "multi") == 0
    assert _run(out, "gpt2-124m", "decode_32k", "--mesh", "both") == 0
    for mesh, n in (("multi", 512), ("pod", 256)):
        with open(out / mesh / "gpt2-124m__decode_32k.json") as f:
            rec = json.load(f)
        assert rec["n_devices"] == rec["roofline"]["n_chips"] == n
        assert ("gpt2-124m", "decode_32k") in port_pm.load_anchors(str(out), mesh)

"""repro_torch.tools on the CPU: the planner calibration writes a schema-
true profile entry that ``thresholds``/``kernel_default`` and
``resolve_plan`` read, merged into an existing file; it refuses to run
without a card unless told ``--device cpu``; and the build-budget gate
passes on the CPU (both digests equal the committed ba4k fingerprint,
the chunked build inside its budget); the flash-attention variant tool
refuses to build without a card.  Timing verdicts taken on the CPU
say nothing of a card, so only the schema is held here; the card's entry
is committed from a chip run.
"""
import json
import os

import pytest
import torch

from repro_torch.core import backends as B
from repro_torch.core import planner_profile as PP
from repro_torch.core.api import NucleusConfig
from repro_torch.tools import calibrate_planner as CP
from repro_torch.tools import check_build_budget as CB
from repro_torch.tools import flash_variants as FV

# one intra-op thread: the suite runs its workers on shared cores
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _fresh_profile_cache():
    PP.reset_cache()
    yield
    PP.reset_cache()


def test_calibration_writes_an_entry_the_planner_reads(tmp_path):
    out = str(tmp_path / "profile.json")
    with open(out, "w") as f:
        json.dump({"format": PP.FORMAT, "version": PP.VERSION,
                   "profiles": {"other": {"tiny_nr": 5}}}, f)
    res = CP.calibrate("cpu", out=out, ladder=(16, 32), repeats=1,
                       log=lambda m: None)
    assert res["keys"] == ["cpu"] and res["kernel_rounds"] == 0
    with open(out) as f:
        blob = json.load(f)
    assert blob["format"] == PP.FORMAT and blob["version"] == PP.VERSION
    assert blob["profiles"]["other"] == {"tiny_nr": 5}     # merged
    entry = blob["profiles"]["cpu"]
    assert entry == res["entry"]
    assert isinstance(entry["tiny_nr"], int)
    assert isinstance(entry["kernel_default"], bool)
    assert "shard_min_incidence" not in entry
    m = entry["measured"]
    assert (m["platform"], m["device_name"], m["power_limit"],
            m["n_devices"], m["quick"]) == ("cpu", "cpu", None, 1, False)
    rows = m["ladder"]
    assert [r["n"] for r in rows] == [16, 32]
    assert entry["tiny_nr"] == CP.crossover(rows)
    assert entry["tiny_nr"] in [r["n_r"] for r in rows] + \
        [rows[-1]["n_r"] + 1]
    th = PP.thresholds(device_kind="cpu", platform="cpu", path=out)
    assert th["tiny_nr"] == entry["tiny_nr"]
    assert th["source"] == "planner_profile['cpu']"
    assert PP.kernel_default("cpu", path=out) is entry["kernel_default"]
    plan = B.resolve_plan(NucleusConfig(backend="auto"), n_r=1000,
                          n_s=1000, n_sub=3, device_kind="cpu",
                          profile_path=out)
    assert any("planner_profile['cpu']" in r for r in plan.reasons)


def test_crossover_is_the_first_dense_win_else_past_the_top():
    rows = [{"n_r": 10, "dense_ms": 2.0, "gather_ms": 1.0},
            {"n_r": 20, "dense_ms": 1.0, "gather_ms": 1.0},
            {"n_r": 40, "dense_ms": 3.0, "gather_ms": 1.0}]
    assert CP.crossover(rows) == 20
    assert CP.crossover(rows[:1] + rows[2:]) == 41


def test_tools_refuse_to_run_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the tools run on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CP.main(["--out", str(tmp_path / "p.json")])
    assert not (tmp_path / "p.json").exists()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CB.gate("cuda")


def test_flash_variants_needs_a_card_and_covers_every_head_dim(
        monkeypatch):
    """Without a card the tool raises before it builds anything, and its
    edge cases hold every head dim the kernel takes to the twin."""
    from repro_torch.kernels.flash_attention import HEAD_DIMS
    assert {c[5] for c in FV.EDGE_CASES} == set(HEAD_DIMS)
    if torch.cuda.is_available():
        pytest.skip("a card is present: the tool runs on it")

    def no_build(*a):
        raise AssertionError("built without a card")
    monkeypatch.setattr(FV, "build", no_build)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FV.main(["-"])


def test_build_gate_passes_on_the_cpu():
    res = CB.gate("cpu", log=lambda m: None)
    assert res["failures"] == []
    with open(CB.GOLDEN) as f:
        golden = json.load(f)
    eager, chunked = res["eager"], res["chunked"]
    assert eager["digest"] == chunked["digest"] == golden["digest"]
    assert chunked["stats"]["n_chunks"] > 1
    assert chunked["accounted_bytes"] <= CB.BUDGET * CB.TOLERANCE < \
        eager["accounted_bytes"]
    # the gate fails a build that went eager, and a digest that drifted
    assert CB.check(eager, eager, golden)
    assert CB.check(eager, dict(chunked, digest="0" * 64), golden)

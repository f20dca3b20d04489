"""The plain reference against the port's plain CPU path at small widths,
through the harness's own run on the CPU: in float32 the two compute the
same functions, so every compared number sits at float32 rounding. Also
the control and the planted faults, which must come out not correct
against the cells' limits."""

import os
import time

import pytest
import torch

from perfbench.core.cli import run_cell

torch.set_num_threads(max(1, min(4, os.cpu_count() or 1)))

FUSION = {"run": dict(num_frames=4, fft_len=64, p_size=16, latent_chan=8,
                      fc_size=256),
          "traffic": dict(batch_size=4)}
FRAMES = {"run": dict(num_frames=2, num_seq=2, hops_per_frame=4, fft_len=64,
                      framesize=24, microbatch=2),
          "traffic": dict(batch_size=4)}
SIZES = {"fusion-train-b256": FUSION, "frames-train-b256": FRAMES}
SEED = 2 ** 31 + 12345


def run(cell, fault=None, control=None, dtype=None):
    over = {k: dict(v) for k, v in SIZES[cell].items()}
    if dtype:
        over["run"]["dtype"] = dtype
    return run_cell(cell, SEED, 0.3, False, torch.device("cpu"),
                    time.perf_counter(), fault=fault, control=control,
                    overrides=over)


@pytest.fixture(autouse=True)
def small_epilogue(monkeypatch):
    # stages 0 and 1 of the 24-pixel frames trunk take K5's route, as the
    # 256-pixel trunk's do
    monkeypatch.setenv("MAAVSS_S2D_MIN_HW", "8")


@pytest.mark.parametrize("cell", sorted(SIZES))
def test_float32_program_matches_reference(cell):
    r = run(cell, dtype="float32")
    assert r["correct"], r["check"]
    for name, row in r["check"].items():
        assert row["value"] < 2e-3, (name, row)


@pytest.mark.parametrize("cell", sorted(SIZES))
def test_float8_control_is_not_correct(cell):
    r = run(cell, control="float8")
    assert not r["correct"], r["check"]


@pytest.mark.parametrize("cell,fault", [
    ("fusion-train-b256", "unchanged"), ("fusion-train-b256", "half_batch"),
    ("frames-train-b256", "unchanged"), ("frames-train-b256", "half_batch")])
def test_planted_fault_is_not_correct(cell, fault):
    r = run(cell, fault=fault)
    assert not r["correct"], r["check"]


def test_a_replay_that_drops_the_update_fails_its_own_number():
    """Under K > 1 the first replay's change is compared on its own: a
    dispatch after the first that leaves the parameters unchanged reads
    about 1 there, and every other number stays within its limit."""
    r = run("fusion-train-b256", fault="replay_unchanged")
    check = r["check"]
    assert check["replay_change_gap"]["value"] > 0.9, check
    for name in ("loss_gap", "grad_gap", "change_gap"):
        assert check[name]["value"] <= check[name]["limit"], (name, check)

"""The result line, the command's exits, and the correctness check against
faults planted under the timed path."""

import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from dicbench import harness

ROOT = Path(__file__).resolve().parents[2]


def run(cell, traced=False, seconds=0.2):
    return harness.run_cell(cell, 2**31 + 11, seconds, traced,
                            time.perf_counter(), device="cpu",
                            backend="torch")


@pytest.mark.parametrize("traced", [False, True])
def test_result_keys(tiny_cell, traced):
    res = run(tiny_cell, traced)
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(res)[-1] == "checks"
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] > 0 and res["attempted"] % tiny_cell.mix["pairs"] == 0
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(
        res["device"])
    names = {m["name"] for m in (tiny_cell.per_layer if traced
                                 else tiny_cell.end_to_end)}
    assert set(res["metrics"]) <= names
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"}
    if traced:
        # On the CPU nothing is read from a device trace or the card.
        assert set(res["metrics"]) == {"seq_host_pct", "lm_iters_per_solve"}
        assert {"busy_s", "window_s"} <= set(res["device"])
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(res["metrics"]) == {"solves_per_s", "peak_mem_gib",
                                       "setup_s"}
    for v in res["checks"].values():
        assert set(v) == {"value", "limit"} and v["value"] <= v["limit"]
    json.dumps(res)


def test_no_card_exits_without_a_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    rc = harness.main(["--workload", "annulus_512.eulerian_first", "--seed",
                       "1", "--seconds", "1", "--trace", "0"])
    out, err = capsys.readouterr()
    assert rc != 0 and out == "" and "needs 1 CUDA device" in err


def test_alone_exits_without_a_result(tmp_path):
    """In a directory with only BENCHMARK.json and the benchmark's files
    the command fails and prints no result."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "dicbench", tmp_path / "dicbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run(
        [sys.executable, "dicbench/run.py", "--workload",
         "annulus_512.eulerian_first", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
        timeout=300, env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert proc.returncode != 0
    assert '"correct"' not in proc.stdout


def test_forbidden_modules_compares_whole_names(monkeypatch):
    assert harness.forbidden_modules() == []
    import correlation_tpu_torch.engine as mod

    monkeypatch.setitem(sys.modules, "correlation_tpu_torchx", mod)
    monkeypatch.setitem(sys.modules, "jaxlibrary.core", mod)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "correlation_tpu.engine", mod)
    monkeypatch.setitem(sys.modules, "jax", mod)
    assert harness.forbidden_modules() == ["correlation_tpu", "jax"]


# Faults planted under the timed path; each must turn `correct` false.

def _step_unchanged(monkeypatch):
    """Every LM step returns the state unchanged (and no next subset)."""
    import correlation_tpu_torch.engine as engine

    def lm_step(cfg, state, out, idx, count, *args):
        nxt = args[-1] if len(args) == 8 else None
        if nxt is not None:
            nxt.zero_()

    monkeypatch.setattr(engine, "lm_step", lm_step)


def _half_left_out(monkeypatch):
    """The chunk solves the first half of the subsets; the rows of the
    other half keep their guess."""
    import correlation_tpu_torch.sequence as seq

    real = seq.correlate_frames

    def correlate_frames(cfg, stack, subsets, guess0, **kw):
        out = real(cfg, stack, subsets, guess0, **kw)
        s, num_p = out["guess"].shape[1], cfg.num_params
        out["packed"][:, s // 2:, :num_p] = out["guess"][:, s // 2:]
        return out

    monkeypatch.setattr(seq, "correlate_frames", correlate_frames)


def _answer_altered(monkeypatch):
    """One subset's u in one pair moved by 0.01 px where it is produced."""
    import correlation_tpu_torch.sequence as seq

    real = seq.correlate_frames

    def correlate_frames(cfg, stack, subsets, guess0, **kw):
        out = real(cfg, stack, subsets, guess0, **kw)
        out["packed"][-1, 5, 0] += 0.01
        return out

    monkeypatch.setattr(seq, "correlate_frames", correlate_frames)


def _subsets_swapped(monkeypatch):
    """The first and the last subset's results exchanged in every pair, as
    a list compaction that scatters to the wrong rows would."""
    import correlation_tpu_torch.sequence as seq

    real = seq.correlate_frames

    def correlate_frames(cfg, stack, subsets, guess0, **kw):
        out = real(cfg, stack, subsets, guess0, **kw)
        out["packed"][:, [0, -1]] = out["packed"][:, [-1, 0]].clone()
        return out

    monkeypatch.setattr(seq, "correlate_frames", correlate_frames)


def _half_shares_a_mean(monkeypatch):
    """The chunk solves the first half of the subsets; the other half
    takes the mean of their parameters."""
    import correlation_tpu_torch.sequence as seq

    real = seq.correlate_frames

    def correlate_frames(cfg, stack, subsets, guess0, **kw):
        out = real(cfg, stack, subsets, guess0, **kw)
        s, num_p = out["guess"].shape[1], cfg.num_params
        out["packed"][:, s // 2:, :num_p] = out["packed"][
            :, :s // 2, :num_p].mean(1, keepdim=True)
        return out

    monkeypatch.setattr(seq, "correlate_frames", correlate_frames)


@pytest.mark.parametrize("fault", [_step_unchanged, _half_left_out,
                                   _answer_altered, _subsets_swapped,
                                   _half_shares_a_mean])
def test_faults_read_incorrect(tiny_cell, fault, monkeypatch):
    fault(monkeypatch)
    res = run(tiny_cell)
    assert res["correct"] is False
    assert any(v["value"] > v["limit"] for v in res["checks"].values())

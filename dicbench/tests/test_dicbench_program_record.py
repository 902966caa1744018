"""The metrics read from the program's own spans and counters
(dicbench.program_record): their values, one recording a run, the
recorded sequences held to the reference."""

import time

import pytest
import torch

from dicbench import harness, program_record, spec

NEW = ("lm_issue_pct", "empty_step_pct", "make_batch_pct", "stage_pct",
       "records_pct")
SEED = 2**31 + 23


def traced(cell):
    return harness.run_cell(cell, SEED, 0.2, True, time.perf_counter(),
                            device="cpu", backend="torch")


def a_run(cell):
    """The Run the metrics read, without a window or a trace."""
    dev = torch.device("cpu")
    inputs = harness.make_inputs(cell, SEED, dev)
    scfg = harness.sequence_config(cell.config, cell.mix, "torch")
    window = dict(wall=1.0, meter_s=0.5, solves=0, failed=0, pairs=0,
                  iterations=0, sequences=1)
    return harness.Run(cell, dev, scfg, inputs, window, None,
                       harness.Outputs())


def test_new_metrics_read_shares(tiny_cell):
    res = traced(tiny_cell)
    assert res["correct"] is True
    for name in NEW:
        assert 0.0 <= res["metrics"][name]["value"] <= 100.0, name
        assert res["metrics"][name]["unit"] == "%"
    # On the CPU the loop stops at the first empty list.
    assert res["metrics"]["empty_step_pct"]["value"] == 0.0


def test_one_recording_a_run(tiny_cell, monkeypatch):
    from correlation_tpu_torch.utils import profiling

    opened = []
    real = profiling.recording

    def counted():
        opened.append(1)
        return real()

    monkeypatch.setattr(profiling, "recording", counted)
    run = a_run(tiny_cell)
    for _ in range(2):
        for name in NEW:
            spec.load("metrics", name, tiny_cell.root).read(run)
    assert len(opened) == 1


def test_recorded_sequences_join_the_outputs(tiny_cell):
    run = a_run(tiny_cell)
    rec = program_record.record(run)
    assert run.outputs.sequences == harness.TRACED_SEQUENCES
    assert run.outputs.pairs == harness.TRACED_SEQUENCES * tiny_cell.mix[
        "pairs"]
    runs = [s for s in rec.spans if s.name == "seq.run"]
    assert len(runs) == harness.TRACED_SEQUENCES
    assert all(s.parent is None for s in runs)


def test_without_recording_nothing_is_read(tiny_cell, monkeypatch):
    """A program from before recording() existed: every new metric is
    left out, and nothing raises."""
    from correlation_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "recording")
    run = a_run(tiny_cell)
    for name in NEW:
        assert spec.load("metrics", name, tiny_cell.root).read(run) is None
    assert run.outputs.sequences == 0


def test_fault_inside_the_recording_reads_incorrect(tiny_cell, monkeypatch):
    """LM steps that leave the state unchanged (and list no subset next)
    while a recording is open, and only then: the window's outputs are
    right, the recorded ones are not, and `correct` reads false."""
    import correlation_tpu_torch.engine as engine
    from correlation_tpu_torch.utils import profiling

    real = engine.lm_step

    def lm_step(cfg, state, out, idx, count, *args):
        if profiling.current_recording() is None:
            return real(cfg, state, out, idx, count, *args)
        nxt = args[-1] if len(args) == 8 else None
        if nxt is not None:
            nxt.zero_()

    monkeypatch.setattr(engine, "lm_step", lm_step)
    assert harness.run_cell(tiny_cell, SEED, 0.2, False, time.perf_counter(),
                            device="cpu", backend="torch")["correct"] is True
    res = traced(tiny_cell)
    assert res["correct"] is False
    assert any(v["value"] > v["limit"] for v in res["checks"].values())


@pytest.mark.parametrize("name", NEW)
def test_entries(name):
    """Each metric is an entry of BENCHMARK.json that every cell reports."""
    for cell in ("rect_grid_1mp.eulerian_first", "annulus_512.eulerian_first"):
        (m,) = [m for m in spec.load_cell(cell).per_layer
                if m["name"] == name]
        assert m["unit"] == "%" and m["moves"] == "solves_per_s"
        assert "workloads" not in m

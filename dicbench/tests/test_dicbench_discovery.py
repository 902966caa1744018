"""A configuration, a mix, a motion, a cell and a per-layer metric added
as new files (and entries of BENCHMARK.json) are taken up with no
existing file of the benchmark edited."""

import hashlib
import json
import shutil
import time
from pathlib import Path

from dicbench import harness, spec

ROOT = Path(__file__).resolve().parents[2]


def _digests(root: Path) -> dict:
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in (root / "dicbench").rglob("*") if p.is_file()
            and "__pycache__" not in p.parts}


def test_new_files_are_found(tmp_path):
    shutil.copytree(ROOT / "dicbench", tmp_path / "dicbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _digests(tmp_path)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    d = tmp_path / "dicbench"
    (d / "configs" / "tiny_grid.json").write_text(json.dumps({
        "source": "test", "frame": {"height": 128, "width": 160,
                                    "bit_depth": 8, "channels": 1},
        "domain": {"kind": "grid", "subsets": 9, "half": 7},
        "solver": {"model": "AFFINE", "interpolation": "BICUBIC",
                   "pyramid": [0, 1], "max_iterations": 50,
                   "precision": 0.001, "backend": "torch"}}))
    (d / "mixes" / "two_pairs.json").write_text(json.dumps({
        "deformation": "EULERIAN", "reference": "FIRST",
        "error_mode": "CONTINUE", "pairs": 2, "frame_chunk": None,
        "motion": {"kind": "row_steps"}}))
    (d / "motions" / "row_steps.py").write_text(
        "import torch\n"
        "from dicbench import texture\n\n\n"
        "def frames(frame, mix, seed, device):\n"
        "    h, w, n = frame['height'], frame['width'], mix['pairs'] + 1\n"
        "    tex = texture.speckle(h + n, w, seed, device).to(torch.uint8)\n"
        "    return torch.stack([tex[n - t:n - t + h] for t in range(n)])"
        "[..., None]\n")
    (d / "cells" / "tiny_grid.two_pairs.json").write_text(json.dumps(
        {"checks": {"uv_gap_px": 0.001}}))
    (d / "metrics" / "pairs_traced.py").write_text(
        "def read(run):\n    return float(run.trace['pairs'])\n")
    bench["configs"].append({"name": "tiny_grid", "source": "test",
                             "file": "dicbench/configs/tiny_grid.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "tiny_grid.two_pairs",
                               "config": "tiny_grid", "traffic": "two_pairs",
                               "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "pairs_traced", "unit": "pairs",
                               "better": "higher", "source": "device_trace",
                               "layer": "engine", "moves": "solves_per_s",
                               "workloads": ["tiny_grid.two_pairs"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.load_cell("tiny_grid.two_pairs", root=tmp_path)
    res = harness.run_cell(cell, 4, 0.1, True, time.perf_counter(),
                           device="cpu")
    assert res["correct"] is True
    assert res["metrics"]["pairs_traced"]["value"] == 2 * 2
    assert set(res["checks"]) == {"uv_gap_px"}
    after = _digests(tmp_path)
    assert {k: after[k] for k in before} == before
    # The cells already there do not take the new metric.
    old = spec.load_cell("annulus_512.eulerian_first", root=tmp_path)
    assert "pairs_traced" not in {m["name"] for m in old.per_layer}

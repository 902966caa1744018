"""Checkpoint / resume of a multi-frame tracking run.

The chained per-sector state (_TrackState) and the completed frame
records are arrays, saved to one .npz file in the JAX package's format
(correlation_tpu/utils/checkpoint.py, version 3; versions 1-3 load), so a
run started by either package resumes in the other.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np

from correlation_tpu_torch.sequence import FrameRecord, _TrackState

# v1 = round-3 payload; v2 (round 5) adds state_chi/state_iterations,
# und_e/def_e, and per-record strain fields; v3 adds the optional
# per-record und_points lists (SequenceConfig.record_points).  Readers
# accept all — older payloads migrate via the key-guarded defaults below.
_FORMAT_VERSION = 3
_READABLE_VERSIONS = {1, 2, 3}


def save_checkpoint(
    path: str,
    next_frame: int,
    state: _TrackState,
    records: list[FrameRecord],
) -> None:
    """Write the resumable state of a sequence run to one .npz file."""
    payload: dict[str, np.ndarray] = {}
    meta = {
        "version": _FORMAT_VERSION,
        "next_frame": next_frame,
        "num_records": len(records),
        "num_sectors": len(state.und_points),
        "und_global_angle": state.und_global_angle,
        "def_global_angle": state.def_global_angle,
        "explicit_centers": state.explicit_centers,
        "und_global_e": state.und_global_e,
        "def_global_e": state.def_global_e,
    }
    for i, pts in enumerate(state.und_points):
        payload[f"und_points_{i}"] = pts
    if state.und_contours is not None:
        for i, c in enumerate(state.und_contours):
            payload[f"und_contour_{i}"] = np.asarray(c)
    if state.def_contours is not None:
        for i, c in enumerate(state.def_contours):
            payload[f"def_contour_{i}"] = np.asarray(c)
    for field in (
        "und_center",
        "past_und_center",
        "und_angle",
        "und_global_center",
        "params",
        "prev_params",
        "guess",
        "def_center",
        "def_angle",
        "def_global_center",
        "chi",
        "iterations",
        "und_e",
        "def_e",
    ):
        v = getattr(state, field)
        if v is not None:
            payload[f"state_{field}"] = np.asarray(v)
    for r, rec in enumerate(records):
        for f in dataclasses.fields(FrameRecord):
            v = getattr(rec, f.name)
            if f.name in ("und_contours", "def_contours", "und_points"):
                if v is not None:
                    for ci, c in enumerate(v):
                        payload[f"rec{r}_{f.name}_{ci}"] = np.asarray(c)
                continue
            if v is None:
                continue
            payload[f"rec{r}_{f.name}"] = np.asarray(v)
    payload["meta"] = np.frombuffer(
        json.dumps(meta).encode(), dtype=np.uint8
    )
    tmp = path + ".tmp"
    np.savez_compressed(tmp, **payload)
    os.replace(tmp + ".npz" if not tmp.endswith(".npz") else tmp, path)


def load_checkpoint(path: str):
    """Returns (next_frame, state, records)."""
    data = np.load(path, allow_pickle=False)
    meta = json.loads(bytes(data["meta"]).decode())
    if meta["version"] not in _READABLE_VERSIONS:
        raise ValueError(f"unsupported checkpoint version {meta['version']}")
    s = meta["num_sectors"]

    def arr(key, default_dtype=np.float32):
        # Fields added after format introduction default to zeros for
        # checkpoints written before them.
        return (
            data[key] if key in data
            else np.zeros(s, default_dtype)
        )

    state = _TrackState(
        und_points=[
            data[f"und_points_{i}"] for i in range(meta["num_sectors"])
        ],
        und_center=data["state_und_center"],
        past_und_center=data["state_past_und_center"],
        und_angle=data["state_und_angle"],
        und_global_center=data["state_und_global_center"],
        und_global_angle=float(meta["und_global_angle"]),
        params=data["state_params"],
        prev_params=data["state_prev_params"],
        guess=data["state_guess"],
        def_center=data["state_def_center"],
        def_angle=data["state_def_angle"],
        def_global_center=data["state_def_global_center"],
        def_global_angle=float(meta["def_global_angle"]),
        explicit_centers=bool(meta["explicit_centers"]),
        und_contours=(
            [data[f"und_contour_{i}"] for i in range(meta["num_sectors"])]
            if "und_contour_0" in data
            else None
        ),
        def_contours=(
            [data[f"def_contour_{i}"] for i in range(meta["num_sectors"])]
            if "def_contour_0" in data
            else None
        ),
        chi=arr("state_chi"),
        iterations=arr("state_iterations", np.int32),
        und_e=arr("state_und_e"),
        def_e=arr("state_def_e"),
        und_global_e=float(meta.get("und_global_e", 0.0)),
        def_global_e=float(meta.get("def_global_e", 0.0)),
    )
    records = []
    num_sectors = meta["num_sectors"]
    for r in range(meta["num_records"]):
        kwargs = {}
        for f in dataclasses.fields(FrameRecord):
            if f.name in ("und_contours", "def_contours", "und_points"):
                keys = [f"rec{r}_{f.name}_{ci}" for ci in range(num_sectors)]
                if keys[0] in data:
                    kwargs[f.name] = [data[k] for k in keys if k in data]
                else:
                    kwargs[f.name] = None
                continue
            key = f"rec{r}_{f.name}"
            if key not in data:
                continue  # field added later; dataclass default applies
            v = data[key]
            if f.name == "frame":
                v = int(v)
            elif f.name in (
                "und_global_angle", "def_global_angle",
                "und_global_e", "def_global_e",
            ):
                v = float(v)
            kwargs[f.name] = v
        records.append(FrameRecord(**kwargs))
    return meta["next_frame"], state, records

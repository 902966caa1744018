"""CSV report: one row per frame pair and sector with centers,
parameters, initial guesses, angles, chi, point count, iterations and error
status.  The bytes equal correlation_tpu/report.py's for the same records.
"""

from __future__ import annotations

import io

from correlation_tpu_torch.sequence import FrameRecord


def report_header(num_params: int) -> str:
    cols = [
        "Frame#",
        "und_file_string",
        "def_file_string",
        "und_global_center_x",
        "und_global_center_y",
        "und_center_x",
        "und_center_y",
        "def_global_center_x",
        "def_global_center_y",
        "def_center_x",
        "def_center_y",
    ]
    cols += [f"parameter_{p}" for p in range(num_params)]
    cols += [f"Initial_guess_{p}" for p in range(num_params)]
    cols += [
        "und_global_angle(rad)",
        "def_global_angle(rad)",
        "und_angle(rad)",
        "def_angle(rad)",
        "def_angle(deg)",
        "chi",
        "number_of_points",
        "iterations",
        "error_status",
        "error_code",
    ]
    return ",".join(cols)


def write_report(
    records: list[FrameRecord],
    file_names: list[str] | None = None,
    reference_first: bool = True,
) -> str:
    """Render the full CSV report for a sequence run."""
    if not records:
        return ""
    num_params = records[0].params.shape[1]
    out = io.StringIO()
    out.write(report_header(num_params) + "\n")
    for rec in records:
        if file_names:
            und_name = file_names[0 if reference_first else rec.frame]
            def_name = file_names[rec.frame + 1]
        else:
            und_name = f"frame_{0 if reference_first else rec.frame}"
            def_name = f"frame_{rec.frame + 1}"
        s = rec.params.shape[0]
        for i in range(s):
            row = [
                str(rec.frame),
                und_name,
                def_name,
                _f(rec.und_global_center[0]),
                _f(rec.und_global_center[1]),
                _f(rec.und_center[i, 0]),
                _f(rec.und_center[i, 1]),
                _f(rec.def_global_center[0]),
                _f(rec.def_global_center[1]),
                _f(rec.def_center[i, 0]),
                _f(rec.def_center[i, 1]),
            ]
            row += [_f(v) for v in rec.params[i]]
            row += [_f(v) for v in rec.initial_guess[i]]
            deg = float(rec.def_angle[i]) * 180.0 / 3.141592653589793
            row += [
                _f(rec.und_global_angle),
                _f(rec.def_global_angle),
                _f(rec.und_angle[i]),
                _f(rec.def_angle[i]),
                _f(deg),
                _f(rec.chi[i]),
                str(int(rec.n_points[i])),
                str(int(rec.iterations[i])),
                str(int(rec.error[i] != 0)),
                str(int(rec.error[i])),
            ]
            out.write(",".join(row) + "\n")
    return out.getvalue()


def _f(v) -> str:
    return repr(float(v))

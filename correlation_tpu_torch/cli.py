"""The command line (port of correlation_tpu/cli.py): image files in, CSV
report out.

Example:
  python -m correlation_tpu_torch.cli frames/*.png \\
      --domain rect --rect 100 100 400 400 --subdivisions 4 4 \\
      --model affine --interp bicubic --pyramid 0 1 2 \\
      --report out.csv

Sharded over several cards, one process a card (--shard):
  torchrun --nproc_per_node=4 -m correlation_tpu_torch.cli frames/*.png \\
      --rect 100 100 400 400 --subdivisions 16 16 --report out.csv --shard
and with --cpu --shard the ranks solve on the CPU over gloo.  Every rank
solves its share of the sectors and holds the whole records; rank 0
alone writes the report, the checkpoint, the overlays and the trace, and
prints.

The flags, defaults, messages and exit codes are the JAX package's, so a
JAX command line runs here unchanged: --backend takes the JAX package's
names as well as the port's (config.JAX_BACKENDS), and --compact-stages
is passed into SolverConfig, where nothing reads it (the port's LM loop
solves only the still-active subsets).  The differences: --cpu solves on
the CPU (without it the run needs a CUDA device and exits 1 where there
is none; --backend cuda with --cpu, or torch without it, exits 2 before
any image is decoded), --profile writes a torch.profiler trace, and
--shard runs under a launcher that starts one process a card (torchrun).
"""

from __future__ import annotations

import argparse
import contextlib
import sys

import numpy as np

from correlation_tpu_torch import domains
from correlation_tpu_torch.config import (
    BACKENDS,
    JAX_BACKENDS,
    DeformationDescription,
    ErrorMode,
    FittingModel,
    Interpolation,
    PyramidConfig,
    ReferenceImage,
    SolverConfig,
)
from correlation_tpu_torch.engine import resolve_assembly, resolve_device
from correlation_tpu_torch.report import write_report
from correlation_tpu_torch.sequence import (
    SequenceConfig,
    run_sequence_from_files,
)

_MODELS = {
    "u": FittingModel.U,
    "uv": FittingModel.UV,
    "uvq": FittingModel.UVQ,
    "affine": FittingModel.AFFINE,
}
_INTERPS = {
    "nearest": Interpolation.NEAREST,
    "bilinear": Interpolation.BILINEAR,
    "bicubic": Interpolation.BICUBIC,
}
_DEFORM = {
    "eulerian": DeformationDescription.EULERIAN,
    "lagrangian": DeformationDescription.LAGRANGIAN,
    "strict-lagrangian": DeformationDescription.STRICT_LAGRANGIAN,
}
_REF = {
    "first": ReferenceImage.FIRST,
    "previous": ReferenceImage.PREVIOUS,
}
_ERRMODE = {
    "stop-all": ErrorMode.STOP_ALL,
    "stop-frame": ErrorMode.STOP_FRAME,
    "continue": ErrorMode.CONTINUE,
}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="correlation_tpu_torch",
        description="batched digital image correlation on a CUDA device",
    )
    ap.add_argument("images", nargs="+", help="ordered frame files")
    ap.add_argument("--domain", choices=["rect", "annular", "blob"],
                    default="rect")
    ap.add_argument("--rect", nargs=4, type=float,
                    metavar=("X0", "Y0", "X1", "Y1"))
    ap.add_argument("--subdivisions", nargs=2, type=int, default=[1, 1],
                    metavar=("HS", "VS"))
    ap.add_argument("--annulus", nargs=4, type=float,
                    metavar=("CX", "CY", "RI", "RO"))
    ap.add_argument("--annular-subdivisions", nargs=2, type=int,
                    default=[1, 1], metavar=("RS", "AS"))
    ap.add_argument("--blob", type=str,
                    help="CSV file of contour x,y rows")
    ap.add_argument("--model", choices=sorted(_MODELS), default="affine")
    ap.add_argument("--interp", choices=sorted(_INTERPS), default="bicubic")
    ap.add_argument("--pyramid", nargs=3, type=int, default=[0, 1, 2],
                    metavar=("START", "STEP", "STOP"))
    ap.add_argument("--max-iters", type=int, default=50)
    ap.add_argument("--precision", type=float, default=1e-3)
    ap.add_argument("--backend", choices=[*BACKENDS, *JAX_BACKENDS],
                    default="auto",
                    help="assembly backend: auto = the fused kernel (its "
                         "plain version on the CPU) up to 3 channels, the "
                         "separable tiles above; cuda / torch = the fused "
                         "kernel / its plain version only; sep = the "
                         "separable-tile assembly (any number of "
                         "channels); field = the coefficient-field "
                         "assembly (no tile-extent limit on warps, any "
                         "number of channels).  The JAX package's names "
                         "take the port's: "
                         + ", ".join(f"{j} = {p}"
                                     for j, p in JAX_BACKENDS.items()))
    ap.add_argument("--tile-margin", type=int, default=8, metavar="PX",
                    help="warp headroom pixels in the fused assembly's "
                         "image tiles beyond subset extent + spline halo "
                         "(default 8); raise for large expected warps")
    ap.add_argument("--compact-stages", type=int, default=6, metavar="N",
                    help="the JAX package's straggler-compaction stages, "
                         "taken for its command lines and read by nothing "
                         "here: the port's LM loop solves only the "
                         "still-active subsets")
    ap.add_argument("--guess", nargs="*", type=float,
                    help="global initial guess parameters")
    ap.add_argument("--auto-guess", action="store_true",
                    help="seed frame 0 by FFT phase correlation of the "
                         "first frame pair: per-sector (u, v) windows "
                         "around every sector center, so spatially varying "
                         "large displacements beyond the pyramid capture "
                         "range seed correctly")
    ap.add_argument("--auto-guess-win", type=int, default=64, metavar="W",
                    help="phase-correlation window size per sector "
                         "(default 64; clipped to the image)")
    ap.add_argument("--deformation", choices=sorted(_DEFORM),
                    default="eulerian")
    ap.add_argument("--reference", choices=sorted(_REF), default="first")
    ap.add_argument("--error-mode", choices=sorted(_ERRMODE),
                    default="continue")
    ap.add_argument("--color", action="store_true",
                    help="correlate RGB instead of monochrome")
    ap.add_argument("--cpu", action="store_true",
                    help="solve on the CPU (without it the run needs a "
                         "CUDA device)")
    ap.add_argument("--report", type=str, default="-",
                    help="report CSV path ('-' = stdout)")
    ap.add_argument("--plot-dir", type=str, default=None,
                    help="write per-frame overlay PNGs (contours + centers) "
                         "here")
    ap.add_argument("--plot-points", action="store_true",
                    help="with --plot-dir: also draw the warped subset "
                         "pixels on each overlay")
    ap.add_argument("--checkpoint", type=str, default=None,
                    help="checkpoint .npz path; resumes from it if present "
                         "and re-saves as the run advances")
    ap.add_argument("--frame-chunk", type=int, default=None, metavar="K",
                    help="Eulerian/Lagrangian sequences: chain K frame "
                         "solves per engine call (1 = per-frame; default: "
                         "SequenceConfig.frame_chunk)")
    ap.add_argument("--checkpoint-every", type=int, default=1,
                    metavar="N", help="save the checkpoint every N frame "
                    "pairs (default 1)")
    ap.add_argument("--profile", type=str, default=None, metavar="DIR",
                    help="write a torch.profiler trace (Chrome JSON) of "
                         "the run to DIR")
    ap.add_argument("--shard", action="store_true",
                    help="shard the sectors over the processes a launcher "
                         "started (torchrun --nproc_per_node=N), one a "
                         "card (gloo on the CPU with --cpu)")
    return ap


class _Reload:
    """Frames decoded again on use, for the overlays (the run keeps none)."""

    def __init__(self, paths, monochrome):
        self.paths = paths
        self.monochrome = monochrome

    def __getitem__(self, idx):
        from correlation_tpu_torch.io import load_image

        return load_image(self.paths[idx], self.monochrome)

    def __len__(self):
        return len(self.paths)


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    mesh = None
    if args.shard:
        from correlation_tpu_torch.parallel.mesh import (
            init_distributed,
            make_mesh,
        )

        device = "cpu" if args.cpu else None
        try:
            joined = init_distributed(device=device)
            mesh = make_mesh(device)
        except RuntimeError as err:
            print(err, file=sys.stderr)
            return 1
        try:
            return _run(args, mesh)
        finally:
            if joined:
                import torch.distributed as dist

                dist.destroy_process_group()
    return _run(args, mesh)


def _run(args, mesh) -> int:
    # Only rank 0 writes and prints; every rank solves.
    lead = mesh is None or mesh.rank == 0
    solver = SolverConfig(
        model=_MODELS[args.model],
        interpolation=_INTERPS[args.interp],
        pyramid=PyramidConfig(*args.pyramid),
        max_iterations=args.max_iters,
        precision=args.precision,
        backend=args.backend,
        tile_margin=args.tile_margin,
        compact_stages=args.compact_stages,
    )
    seq_kwargs = (
        {} if args.frame_chunk is None
        else {"frame_chunk": args.frame_chunk}
    )
    eulerian = _DEFORM[args.deformation] == DeformationDescription.EULERIAN
    cfg = SequenceConfig(
        solver=solver,
        deformation=_DEFORM[args.deformation],
        reference=_REF[args.reference],
        error_mode=_ERRMODE[args.error_mode],
        **seq_kwargs,
        # Lagrangian point overlays need each frame's moved point lists.
        record_points=(
            args.plot_points and args.plot_dir is not None and not eulerian
        ),
    )

    from correlation_tpu_torch import viz

    centers = None
    if args.domain == "rect":
        if not args.rect:
            print("--rect required for rectangular domains", file=sys.stderr)
            return 2
        dom = domains.RectangularDomain(
            *args.rect,
            horizontal_subdivisions=args.subdivisions[0],
            vertical_subdivisions=args.subdivisions[1],
        )
        cs, xdim, ydim = domains.rectangular_sectors(dom)
        point_lists = [
            domains.rectangular_points(int(c[0]), int(c[1]), xdim, ydim)
            for c in cs
        ]
        centers = cs
        global_center = np.array([dom.x_center, dom.y_center], np.float32)
        contours = [
            viz.rect_outline(c[0] - xdim, c[1] - ydim,
                             c[0] + xdim, c[1] + ydim)
            for c in cs
        ]
    elif args.domain == "annular":
        if not args.annulus:
            print("--annulus required", file=sys.stderr)
            return 2
        cx, cy, ri, ro = args.annulus
        dom = domains.AnnularDomain(
            cx, cy, ri, ro,
            radial_subdivisions=args.annular_subdivisions[0],
            angular_subdivisions=args.annular_subdivisions[1],
        )
        batch0 = domains.annular_batch(dom, 0)
        point_lists = [
            batch0.xy[0][i][batch0.mask[0][i]]
            for i in range(batch0.num_subsets)
        ]
        global_center = np.array([cx, cy], np.float32)
        contours = viz.annulus_outlines(
            cx, cy, ri, ro,
            radial_subdivisions=args.annular_subdivisions[0],
            angular_subdivisions=args.annular_subdivisions[1],
        )
    else:
        if not args.blob:
            print("--blob required", file=sys.stderr)
            return 2
        contour = np.loadtxt(args.blob, delimiter=",").reshape(-1, 2)
        dom = domains.BlobDomain(contour)
        batch0 = domains.blob_batch(dom, 0)
        point_lists = [batch0.xy[0][0][batch0.mask[0][0]]]
        global_center = np.array(
            [dom.x_center, dom.y_center], np.float32
        )
        contours = [contour.astype(np.float32)]

    guess = (
        np.asarray(args.guess, np.float32)
        if args.guess
        else np.zeros(solver.num_params, np.float32)
    )
    if len(guess) != solver.num_params:
        print(
            f"--guess needs {solver.num_params} values for {args.model}",
            file=sys.stderr,
        )
        return 2
    if args.auto_guess:
        if args.guess:
            print(
                "--auto-guess cannot be combined with --guess "
                "(pick one initial-guess source)",
                file=sys.stderr,
            )
            return 2
        if len(args.images) < 2:
            print("--auto-guess needs at least two images", file=sys.stderr)
            return 2

    # The device is chosen before any image is decoded: the card, unless
    # --cpu asks for the CPU (a rank's, with --shard).  No card and no
    # --cpu ends the run here (1), and so does a backend that does not
    # solve on the device chosen (2, an argument error).
    try:
        device = resolve_device(solver, "cpu" if args.cpu else None,
                                mesh=mesh)
    except RuntimeError as err:
        print(err, file=sys.stderr)
        return 1
    except ValueError as err:
        print(err, file=sys.stderr)
        return 2
    if (mesh is not None and mesh.device.type == "cuda"
            and resolve_assembly(solver, 3 if args.color else 1) == "tiled"):
        # Rank 0 builds the fused kernel's library the others then load.
        from correlation_tpu_torch.ops import _build
        from correlation_tpu_torch.parallel.mesh import barrier

        if lead:
            _build.load_library()
        barrier(mesh)

    per_sector_guess = None
    if args.auto_guess:
        from correlation_tpu_torch.io import load_image
        from correlation_tpu_torch.ops.seed import phase_correlation_guess

        sector_centers = (
            centers
            if centers is not None
            else np.array([p.mean(axis=0) for p in point_lists], np.float32)
        )
        per_sector_guess = phase_correlation_guess(
            load_image(args.images[0], not args.color),
            load_image(args.images[1], not args.color),
            sector_centers,
            win=args.auto_guess_win,
            device=device,
        )
        if lead:
            print(
                "auto-guess (per-sector phase correlation): "
                f"u in [{per_sector_guess[:, 0].min():.0f}, "
                f"{per_sector_guess[:, 0].max():.0f}], "
                f"v in [{per_sector_guess[:, 1].min():.0f}, "
                f"{per_sector_guess[:, 1].max():.0f}]",
                file=sys.stderr,
            )

    with contextlib.ExitStack() as stack:
        if args.profile and lead:
            from correlation_tpu_torch.utils import profiling

            profiling.start_trace(args.profile)
            stack.callback(
                lambda: print(f"wrote trace {profiling.stop_trace()}",
                              file=sys.stderr))
        # Frames decode in a background prefetcher as the solve advances,
        # so a long run never holds the sequence in memory.
        records = run_sequence_from_files(
            args.images,
            point_lists,
            cfg,
            monochrome=not args.color,
            global_guess=guess,
            centers=centers,
            global_center=global_center,
            contours=contours,
            per_sector_guess=per_sector_guess,
            checkpoint_path=args.checkpoint,
            checkpoint_every=args.checkpoint_every,
            device=device,
            mesh=mesh,
        )
    if not lead:
        return 0
    if args.plot_dir:
        plot_points = args.plot_points
        paths = viz.save_sequence_overlays(
            _Reload(args.images, not args.color), records, args.plot_dir,
            point_lists=point_lists if plot_points else None,
            model=solver.model if plot_points else None,
            eulerian=eulerian,
        )
        print(f"wrote {len(paths)} overlay images to {args.plot_dir}")
    csv = write_report(
        records,
        file_names=args.images,
        reference_first=cfg.reference == ReferenceImage.FIRST,
    )
    if args.report == "-":
        sys.stdout.write(csv)
    else:
        with open(args.report, "w") as f:
            f.write(csv)
        print(f"wrote {args.report} ({len(records)} frame pairs)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

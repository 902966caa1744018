"""The port's public surface held to the JAX package's.

For each module of the JAX package, every public function and class it
defines (jitted functions included) has a counterpart of the same name in
the port's module, which accepts every JAX parameter name (a class: every
constructor argument); every enum has the same members with the same
values; every name in the JAX packages' __all__ imports from the port's
counterpart; and every option of the JAX command line is taken by the
port's, with the same default and at least the same choices.  Each
exception is written down in EXCEPTIONS with its reason, and an exception
that no longer excuses a gap fails as well.  The test only imports: it
compiles nothing.
"""

import enum
import importlib
import inspect
import pkgutil

import pytest

import correlation_tpu

MODULES = ["config", "domains", "engine", "io", "models.warp",
           "ops.assemble", "ops.assemble_v2", "ops.interp", "ops.pyramid",
           "ops.seed", "ops.solve", "parallel.collectives", "parallel.mesh",
           "polygon", "report", "sequence", "utils.checkpoint",
           "utils.profiling", "viz", "cli"]

_SCHEDULE = "Pallas kernel schedule; ROADMAP \"Do not port\""
_LAYOUT = "JAX's element-major layout; the port packs `pix`"
_ASSEMBLY = "maps to field_assemble and sep_assemble (packed pixel rows)"
_PALLAS = "VMEM, DMA and lane mechanics of the Pallas kernel"
_ONE_PROCESS = ("one process a card over torch.distributed; the port takes "
                "device=")

# Key: "module.name" for a missing name, "module.name(param=)" for a
# parameter the port's counterpart does not take, and a bare module name
# for a module without a port.
EXCEPTIONS = {
    "engine.resolve_backend":
        "maps to engine.resolve_assembly (the port's assembly names)",
    "engine.compute_level_statics(backend=)": _SCHEDULE,
    "engine.compute_level_statics(shard_divisor=)": _SCHEDULE,
    "engine.compute_level_statics(integral_override=)": _SCHEDULE,
    **{f"engine.LevelStatic({f}=)": _SCHEDULE
       for f in ("block", "parts", "gram", "slack", "group", "sel", "tsrc",
                 "p_sub")},
    **{f"engine.LevelArrays({f}=)": _LAYOUT
       for f in ("xy", "mask", "und_w", "pixdata")},
    "domains.SubsetBatch(group_extents=)":
        "_level_group_extents; ROADMAP \"Do not port\"",
    "ops.assemble.assemble_normal_equations": _ASSEMBLY,
    "ops.assemble.assemble_normal_equations_tiles": _ASSEMBLY,
    **{f"ops.assemble_v2.{n}": _PALLAS
       for n in ("FusedAssembly", "extract_tiles", "pack_pixdata",
                 "dma_width", "prepared_img_bytes", "choose_block")},
    "ops.assemble_v2.compute_origins(group=)": _PALLAS,
    # fused_assemble is jitted: the wrapper's __wrapped__ is the function.
    "ops.assemble_v2.fused_assemble(pixdata=)": _LAYOUT,
    **{f"ops.assemble_v2.fused_assemble({p}=)": _PALLAS
       for p in ("block", "interpret", "in_kernel_dma", "img_prepared",
                 "tile_parts", "gram_mode", "row_slack", "group", "sel_mode",
                 "tile_src", "ablate", "p_sub")},
    "ops.solve.lm_delta_rows":
        "the dual layout; ROADMAP \"Do not port\"",
    "parallel.mesh.make_mesh(devices=)": _ONE_PROCESS,
    "parallel.collectives.make_pixel_mesh(devices=)": _ONE_PROCESS,
    "parallel.mesh.init_distributed(**kwargs)": _ONE_PROCESS,
    "native": "host C++ fast path with a NumPy fallback; ROADMAP \"Do not "
              "port\" (ROADMAP \"Findings\")",
}


def _defined(module):
    """The public functions and classes `module` defines, unwrapped."""
    for name, obj in vars(module).items():
        obj = getattr(obj, "__wrapped__", obj)
        if (not name.startswith("_")
                and (inspect.isfunction(obj) or inspect.isclass(obj))
                and obj.__module__ == module.__name__):
            yield name, obj


def _gaps(name):
    """The keys of every way the port's module `name` falls short of the
    JAX module's."""
    ref = importlib.import_module(f"correlation_tpu.{name}")
    port = importlib.import_module(f"correlation_tpu_torch.{name}")
    gaps = set()
    for attr, want in _defined(ref):
        key = f"{name}.{attr}"
        if not hasattr(port, attr):
            gaps.add(key)
            continue
        got = getattr(port, attr)
        if inspect.isclass(want) and issubclass(want, enum.Enum):
            if ({m.name: m.value for m in got}
                    != {m.name: m.value for m in want}):
                gaps.add(key)
            continue
        taken = inspect.signature(got).parameters.values()
        any_kw = any(p.kind == p.VAR_KEYWORD for p in taken)
        names = {p.name for p in taken}
        for p in inspect.signature(want).parameters.values():
            if p.kind == p.VAR_KEYWORD and not any_kw:
                gaps.add(f"{key}(**{p.name})")
            elif (p.kind in (p.POSITIONAL_OR_KEYWORD, p.KEYWORD_ONLY)
                  and p.name not in names and not any_kw):
                gaps.add(f"{key}({p.name}=)")
    return gaps


@pytest.mark.parametrize("name", MODULES)
def test_module_matches_jax(name):
    gaps = _gaps(name)
    excused = {k for k in EXCEPTIONS if k.startswith(f"{name}.")}
    assert gaps - excused == set(), "the port lacks these"
    assert excused - gaps == set(), "these exceptions excuse nothing"


def test_every_jax_module_has_a_port():
    found = {m.name.removeprefix("correlation_tpu.")
             for m in pkgutil.walk_packages(correlation_tpu.__path__,
                                            "correlation_tpu.")
             if not m.ispkg}
    assert found - set(MODULES) == {k for k in EXCEPTIONS if "." not in k}
    for name in MODULES:
        importlib.import_module(f"correlation_tpu_torch.{name}")


@pytest.mark.parametrize("package", ["", "ops", "models", "parallel", "utils"])
def test_jax_exports_import_from_the_port(package):
    """Every name in the JAX package's __all__ (and its subpackages') is
    in the port's __all__, unless the module that defines it is excused."""
    suffix = f".{package}" if package else ""
    ref = importlib.import_module(f"correlation_tpu{suffix}")
    port = importlib.import_module(f"correlation_tpu_torch{suffix}")
    for name in ref.__all__:
        home = getattr(getattr(ref, name), "__module__", None) or ""
        key = f"{home.removeprefix('correlation_tpu.')}.{name}"
        if key in EXCEPTIONS:
            assert name not in port.__all__, key
            continue
        assert name in port.__all__ and hasattr(port, name), name


def test_cli_takes_every_jax_option():
    """Every JAX option: the same flag and default, and at least its
    choices; so a JAX command line parses on the port."""
    from correlation_tpu import cli as jcli
    from correlation_tpu_torch import cli

    def options(parser):
        return {s: a for a in parser._actions for s in a.option_strings}

    ref, got = options(jcli.build_parser()), options(cli.build_parser())
    assert set(ref) - set(got) == set()
    for flag, want in ref.items():
        have = got[flag]
        assert (have.dest, have.default, have.nargs) == \
            (want.dest, want.default, want.nargs), flag
        assert set(want.choices or ()) <= set(have.choices or ()), flag

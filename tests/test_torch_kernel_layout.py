"""The kernel-wrapper layer's layout and its plans, on the CPU.

One module (``ops/cuda_library``) builds, loads and binds the CUDA library;
the launchers (``ops/deint_kernel``, ``ops/pool_kernel``,
``parallel/shard_kernel``, ``tools/probe_kernel``) and the launch geometry
they share (``ops/launch_geometry``) import one another without a cycle,
and no package module reads their private names, nor they another
module's.  Each plane pass is planned once (``deint_kernel.field_plan``):
the plans of the benchmark's passes are pinned here as literals.  This
module imports neither JAX nor the test conftest.
"""

import ast
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from sangnom_tpu_torch.core.formats import get_format  # noqa: E402
from sangnom_tpu_torch.core.geometry import buffer_stride_elems  # noqa: E402
from sangnom_tpu_torch.ops import cuda_library as cl  # noqa: E402
from sangnom_tpu_torch.ops import deint_kernel as dk  # noqa: E402
from sangnom_tpu_torch.ops import pool_kernel as pk  # noqa: E402
from sangnom_tpu_torch.ops.primitives import KernelSpec  # noqa: E402

PKG = Path(__file__).resolve().parent.parent / "sangnom_tpu_torch"
LAYER = {"sangnom_tpu_torch.ops.cuda_library", "sangnom_tpu_torch.ops.launch_geometry",
         "sangnom_tpu_torch.ops.deint_kernel", "sangnom_tpu_torch.ops.pool_kernel",
         "sangnom_tpu_torch.parallel.shard_kernel", "sangnom_tpu_torch.tools.probe_kernel"}


def _modules() -> dict:
    """Module name -> its parsed source, for every module of the package."""
    out = {}
    for path in PKG.rglob("*.py"):
        parts = path.relative_to(PKG.parent).with_suffix("").parts
        name = ".".join(parts[:-1] if parts[-1] == "__init__" else parts)
        out[name] = ast.parse(path.read_text())
    return out


def _imports(tree, modules) -> tuple[dict, list]:
    """(alias -> package module, [(module, name)] of names imported from a
    package module), module- and function-level imports alike."""
    aliases, names = {}, []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name in modules:
                    aliases[a.asname or a.name] = a.name
        elif isinstance(node, ast.ImportFrom) and node.module in modules:
            for a in node.names:
                sub = f"{node.module}.{a.name}"
                if sub in modules:
                    aliases[a.asname or a.name] = sub
                else:
                    names.append((node.module, a.name))
    return aliases, names


def _private(name: str) -> bool:
    return name.startswith("_") and not name.startswith("__")


def test_layer_imports_are_acyclic_and_private_names_stay_home():
    """The layer's import graph, lazy imports included, has no cycle; no
    package module reads a private name of the layer's modules, and no
    module of the layer reads another module's private name."""
    modules = _modules()
    assert LAYER <= set(modules)
    graph, reads = {}, []
    for name, tree in modules.items():
        aliases, names = _imports(tree, modules)
        deps = set(aliases.values()) | {m for m, _ in names}
        graph[name] = deps & LAYER - {name}
        reads += [(name, m, n) for m, n in names if _private(n)]
        for node in ast.walk(tree):
            if (isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name)
                    and node.value.id in aliases and _private(node.attr)):
                reads.append((name, aliases[node.value.id], node.attr))
    bad = [r for r in reads if r[0] != r[1] and (r[0] in LAYER or r[1] in LAYER)]
    assert not bad, bad

    def visit(node, path):
        assert node not in path, f"import cycle: {' -> '.join(path + [node])}"
        for dep in graph[node]:
            visit(dep, path + [node])

    for name in LAYER:
        visit(name, [])


def test_one_module_binds_the_library_and_each_plan_is_made_once():
    """Only ``cuda_library`` loads the CUDA library and sets argument types
    (``oracle`` loads its own C library, the native reference);
    `shard_kernel.one_wave_smem` is called in one place
    (`shard_kernel.pass_plan`), and ``full_pass`` launches the plan it is
    given without planning."""
    modules = _modules()
    binders, wave_calls, full_pass_calls = set(), [], []
    for name, tree in modules.items():
        for node in ast.walk(tree):
            if isinstance(node, ast.Attribute) and node.attr in ("CDLL", "argtypes", "restype"):
                binders.add(name)
            if isinstance(node, ast.FunctionDef):
                for call in ast.walk(node):
                    if isinstance(call, ast.Call):
                        fn = call.func
                        called = fn.attr if isinstance(fn, ast.Attribute) else getattr(fn, "id", "")
                        if called == "one_wave_smem":
                            wave_calls.append((name, node.name))
                        if node.name == "full_pass" and called in ("full_plan", "pass_plan"):
                            full_pass_calls.append(called)
    assert binders == {"sangnom_tpu_torch.ops.cuda_library", "sangnom_tpu_torch.oracle"}
    assert wave_calls == [("sangnom_tpu_torch.parallel.shard_kernel", "pass_plan")]
    assert not full_pass_calls
    for gone in ("_overlap_plans", "_card_plan", "_is_wide", "PassShape"):
        assert not hasattr(dk, gone)


# The benchmark's passes: (cell, plane, format, fields, width, kept rows,
# stride) -> the plan (k, W_loc, plan fields, blocks) the launch runs on an
# H100, as the code before `field_plan` made it.
CELL_PASSES = [
    ("bob1080i", "luma", "YUV420P8", 120, 1920, 540, 1920,
     (1, 1920, (4, 480, "double", 164128, 1932, 1936, 1920), 120)),
    ("bob1080i", "uv", "YUV420P8", 240, 960, 270, 1920,
     (1, 1024, (4, 256, "double", 87712, 1036, 976, 1024), 240)),
    ("maa2160p", "luma", "YUV420P8", 24, 3840, 1080, 3840,
     (4, 960, (8, 24, 4, 256, True, 1, "double", 115713, 1020, 1024, 1024), 96)),
    ("maa2160p", "uv", "YUV420P8", 48, 1920, 540, 3840,
     (1, 2048, (4, 512, "double", 174496, 2060, 1936, 2048), 48)),
    ("yuv422p10_1080i", "luma", "YUV422P10", 120, 1920, 540, 1920,
     (1, 1920, (4, 480, "double", 189152, 1932, 1936, 1920), 120)),
    ("yuv422p10_1080i", "uv", "YUV422P10", 240, 960, 540, 1920,
     (1, 1024, (4, 256, "double", 100832, 1036, 976, 1024), 240)),
]


@pytest.mark.parametrize("cell,plane,fname,fields,w,bufH,stride,want", CELL_PASSES,
                         ids=[f"{c[0]}-{c[1]}" for c in CELL_PASSES])
def test_field_plan_of_the_cells(cell, plane, fname, fields, w, bufH, stride, want):
    """Each API cell's pass plans as before: the bobs' K1 launches, and the
    maa luma's K4 over 4 blocks of 960 on a cluster at 115713 bytes (the
    one-wave padding) beside its U+V's K1."""
    fmt = get_format(fname)
    spec = KernelSpec.from_format(fmt)
    assert buffer_stride_elems(w if plane == "luma" else 2 * w, fmt.component_size) == stride
    fp = dk.field_plan(fields, w, bufH, stride, spec, cl.H100)
    assert (fp.k, fp.W_loc, tuple(fp.plan), fp.blocks) == want


def test_pool_walk_of_the_compat_cell():
    """The compat cell runs no field pass: its luma and U+V pools walk one
    block a map (`pool_kernel.walk_plan`), as before."""
    assert tuple(pk.walk_plan(1920, 539)) == (1, 1920, 0, 0, 4, 480, False, 1, 1932, 15456)
    assert tuple(pk.walk_plan(960, 269)) == (1, 960, 0, 0, 4, 256, False, 1, 972, 7776)


# GRAY8 width S (its buffer stride) -> K4's (k, W_loc, R, threads, cluster, launches,
# smem_bytes) for 24 fields of 1, 4 and 540 kept rows, as before.
WIDE_PLANS = {
    2049: ((3, 685, 1, 192, True, 1, 115713), (3, 688, 3, 192, True, 1, 115713),
           (3, 692, 8, 192, True, 1, 115713)),
    2056: ((3, 688, 1, 192, True, 1, 115713), (3, 691, 3, 192, True, 1, 115713),
           (4, 520, 8, 160, True, 1, 115713)),
    3840: ((4, 960, 1, 256, True, 1, 115713), (4, 960, 3, 256, True, 1, 115713),
           (4, 960, 8, 256, True, 1, 115713)),
    4096: ((8, 512, 1, 160, True, 1, 47216), (8, 512, 3, 160, True, 1, 48944),
           (8, 512, 8, 160, True, 1, 53280)),
    7680: ((8, 960, 1, 256, True, 1, 85168), (8, 960, 3, 256, True, 1, 86896),
           (8, 960, 8, 256, True, 1, 91232)),
    8192: ((8, 1024, 1, 288, True, 1, 91248), (8, 1024, 3, 288, True, 1, 92976),
           (8, 1024, 8, 288, True, 1, 97312)),
    8193: ((5, 1640, 1, 416, True, 1, 143248), (5, 1642, 3, 448, True, 1, 146208),
           (5, 1644, 8, 448, True, 1, 150832)),
    8224: ((8, 1028, 1, 288, True, 1, 91536), (8, 1028, 3, 288, True, 1, 93344),
           (8, 1028, 8, 288, True, 1, 97600)),
    12288: ((8, 1536, 1, 416, True, 1, 135280), (8, 1536, 3, 416, True, 1, 137008),
            (8, 1536, 8, 416, True, 1, 141344)),
    15360: ((8, 1920, 1, 512, True, 1, 168304), (8, 1920, 3, 512, True, 1, 170032),
            (8, 1920, 8, 512, True, 1, 174368)),
    16384: ((16, 1024, 1, 288, False, 1, 90816), (16, 1024, 3, 288, False, 1, 91680),
            (16, 1024, 8, 288, False, 68, 93856)),
    32768: ((32, 1024, 1, 288, False, 1, 90816), (32, 1024, 3, 288, False, 1, 91680),
            (32, 1024, 8, 288, False, 68, 93856)),
    65280: ((34, 1920, 1, 512, False, 1, 167872), (34, 1920, 3, 512, False, 1, 168736),
            (34, 1920, 8, 512, False, 68, 170912)),
    65536: ((64, 1024, 1, 288, False, 1, 90816), (64, 1024, 3, 288, False, 1, 91680),
            (64, 1024, 8, 288, False, 68, 93856)),
}


@pytest.mark.parametrize("S", sorted(WIDE_PLANS))
def test_field_plan_of_wide_fields(S):
    """The wide route's plans at the widths of ``test_wide_plan``: k, W_loc,
    R, threads, route, launches and the shared memory a launch asks for,
    the one-wave padding (115713 bytes) where 24 fields' blocks fit one a
    SM."""
    spec = KernelSpec.from_format(get_format("GRAY8"))
    got = []
    for bufH in (1, 4, 540):
        fp = dk.field_plan(24, S, bufH, buffer_stride_elems(S, 1), spec, cl.H100)
        p = fp.plan
        assert fp.blocks == 24 * fp.k
        got.append((fp.k, fp.W_loc, p.R, p.threads, p.cluster, p.launches, p.smem_bytes))
    assert tuple(got) == WIDE_PLANS[S]

"""Guards of the port: it stands alone (no JAX, no ndsm_tpu), it never
hides the device or a kernel behind a fallback, and it takes every option
of the JAX package and ignores none."""

import ast
import dataclasses
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import ndsm_tpu
import ndsm_tpu_torch
from ndsm_tpu_torch import Options, convert
from ndsm_tpu_torch.utils import cuda_build
from ndsm_tpu_torch.utils.device import resolve_device

torch.set_num_threads(1)

PKG = pathlib.Path(ndsm_tpu_torch.__file__).resolve().parent
REPO = PKG.parent


def _modules():
    return sorted(PKG.rglob("*.py"))


def test_import_leaves_jax_out():
    code = ("import sys, ndsm_tpu_torch, ndsm_tpu_torch.api, ndsm_tpu_torch.convert, "
            "ndsm_tpu_torch.ops.zc, ndsm_tpu_torch.ops.df, ndsm_tpu_torch.ops.fused, "
            "ndsm_tpu_torch.ops.compact, ndsm_tpu_torch.ops.stencils_compact, "
            "ndsm_tpu_torch.mg.batched, ndsm_tpu_torch.utils.cuda_build, "
            "ndsm_tpu_torch.ops.zc_sharded, ndsm_tpu_torch.ops.df_sharded, "
            "ndsm_tpu_torch.parallel.shard, ndsm_tpu_torch.parallel.collectives, "
            "ndsm_tpu_torch.parallel.sm_engine, ndsm_tpu_torch.mg.operator, "
            "ndsm_tpu_torch.utils.profiling, ndsm_tpu_torch.examples.integration_scaling, "
            "ndsm_tpu_torch.examples.unit_test_2d_solve; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
            "or m == 'ndsm_tpu' or m.startswith('ndsm_tpu.')]; print(bad); "
            "sys.exit(1 if bad else 0)")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(REPO), env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_no_jax_import_in_source():
    for path in _modules():
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for n in names:
                top = n.split(".")[0]
                assert top not in ("jax", "jaxlib", "ndsm_tpu"), f"{path}: imports {n}"


def test_no_exception_handlers_in_package():
    """No broad try/except anywhere in the port: a kernel error is never
    turned into a plain-torch run, a missing device never into a CPU run.
    The handlers allowed are the LRU cache's ``except KeyError`` and one
    ``except RuntimeError`` in mg/graphs.py around a CUDA graph's capture,
    after which the same kernels run eagerly (their errors still raise)."""
    handlers = []
    for path in _modules():
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.ExceptHandler):
                caught = node.type.id if isinstance(node.type, ast.Name) else None
                if caught == "RuntimeError" and path == PKG / "mg" / "graphs.py":
                    handlers.append(node)
                    continue
                assert caught == "KeyError", f"{path}:{node.lineno} catches {ast.dump(node.type)}"
    assert len(handlers) == 1


def test_cuda_device_raises_without_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    x = np.linspace(0, 1, 8)
    b = np.zeros((3, 8, 8, 8))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ndsm_tpu_torch.vector_potential(x, x, x, b)  # device="cuda" is the default
    with pytest.raises(RuntimeError):
        ndsm_tpu_torch.vector_potential(x, x, x, b, device="cuda:0")
    h = ndsm_tpu_torch.GridHierarchy.from_mesh((x, x, x))
    with pytest.raises(RuntimeError):
        ndsm_tpu_torch.PoissonBVP(h, (("D", "D"),) * 3, device="cuda")


def test_multibc_solver_raises_without_card():
    """MultiBCSolver runs on the card unless told otherwise: with
    device="cuda" (its default) it raises without one."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    x = np.linspace(0, 1, 8)
    h = ndsm_tpu_torch.GridHierarchy.from_mesh((x, x, x))
    bcs = [(("D", "D"), ("D", "D"), ("N", "N"))]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ndsm_tpu_torch.MultiBCSolver(h, bcs, Options(), device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ndsm_tpu_torch.MultiBCSolver(h, bcs)
    assert ndsm_tpu_torch.MultiBCSolver(h, bcs, device="cpu").device.type == "cpu"


def test_poisson_bvp_defaults_to_the_card():
    """PoissonBVP and get_poisson_bvp run on the card unless the caller
    asks for the CPU: with no device argument they raise without one."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    from ndsm_tpu_torch.mg.poisson import get_poisson_bvp

    x = np.linspace(0, 1, 8)
    h = ndsm_tpu_torch.GridHierarchy.from_mesh((x, x))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ndsm_tpu_torch.PoissonBVP(h, (("N", "N"),) * 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        get_poisson_bvp(h, (("N", "N"),) * 2)
    assert ndsm_tpu_torch.PoissonBVP(h, (("N", "N"),) * 2, device="cpu").device.type == "cpu"


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    if any(pathlib.Path(p, "nvcc").exists() for p in ("/usr/local/cuda/bin",)):
        pytest.skip("this host has nvcc in the default location")
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc was not found"):
        cuda_build.find_nvcc()


def test_precision_resolution():
    o = Options()
    assert o.resolve_precision("cuda") == "mixed"
    assert o.resolve_precision(torch.device("cuda", 0)) == "mixed"
    assert o.resolve_precision("cpu") == "fp64"
    assert o.resolve_precision() == "fp64"
    assert Options(precision="fp32").resolve_precision("cuda") == "fp32"


@pytest.mark.parametrize("kw", [
    {"per_face": True},
    {"host_curl": True},
    {"fetch_encoding": "split16"},
])
def test_formerly_unported_options_carried_by_convert(kw):
    """per_face, host_curl and fetch_encoding are ported: the port's
    Options take every value of the JAX package's, and convert carries
    them through unchanged."""
    o = Options(**kw)
    assert convert.options_from_reference(dataclasses.asdict(ndsm_tpu.Options(**kw))) == o
    for name, val in kw.items():
        assert getattr(o, name) == val


@pytest.mark.parametrize("mode", ["on", "off", "auto"])
def test_batch_components_carried_by_convert(mode):
    """Every batch_components value of the JAX package is ported: the
    port's Options take it, and convert carries it through unchanged."""
    ref = dataclasses.asdict(ndsm_tpu.Options(batch_components=mode, precision="mixed"))
    o = convert.options_from_reference(ref)
    assert o.batch_components == mode and o == Options(batch_components=mode, precision="mixed")
    with pytest.raises(ValueError):
        Options(batch_components="sometimes")


def test_batch_components_auto_is_sequential_on_cpu():
    """"auto" batches only on a CUDA device outside fp64 (JAX resolves its
    kernels off on a CPU host and runs the components one by one); "on"
    batches anywhere, except where the lanes' ms would differ."""
    from ndsm_tpu_torch.potential.vector_potential import _batch_components

    cpu, shape = torch.device("cpu"), (22, 22, 22)
    for mode in ("mixed", "fp64", "fp32"):
        assert not _batch_components(Options(), mode, shape, cpu)
        assert _batch_components(Options(batch_components="on"), mode, shape, cpu)
        assert not _batch_components(Options(batch_components="off"), mode, shape, cpu)
    assert not _batch_components(Options(batch_components="on", honor_ms_for_az=False),
                                 "mixed", shape, cpu)
    x = np.linspace(0, 1, 8)
    b = np.zeros((3, 8, 8, 8))
    _, _, _, info = ndsm_tpu_torch.vector_potential(
        x, x, x, b, device="cpu", full_output=True, precision="mixed")
    assert [s.batch_size for s in info.components] == [1, 1, 1]


def test_unported_arguments_raise():
    for bad in ("off", "interpret"):
        with pytest.raises(ValueError):
            Options(use_pallas=bad)
    with pytest.raises(ValueError):  # no option is accepted and ignored
        Options(smoother="bogus")
    with pytest.raises(TypeError):
        convert.options_from_reference({"ms": 5, "no_such_option": 1})


def test_kernel_sources_packaged():
    """The CUDA sources ship with the package (pyproject package-data)."""
    names = {p.name for p in (PKG / "csrc").iterdir()}
    assert {"zc_smooth.cu", "defect.cu", "fused_smooth.cu", "compact_smooth.cu",
            "zc_sharded.cu", "stencil.cuh"} <= names
    text = (REPO / "pyproject.toml").read_text()
    assert '"ndsm_tpu_torch" = ["csrc/*.cu", "csrc/*.cuh"]' in text


# The C entry points of the kernel library that are not rows of
# cuda_build._SIGNATURES, or that no module of the package calls, and why.
_NOT_IN_TABLE = {"ndsm_error_string": "returns a string; kernels() sets its types apart"}
_NO_CALLER = {"ndsm_mean_resident_blocks": "returns the card's resident blocks of the "
              "all-Neumann cooperative grid, which chip_smoke.py prints and checks"}


def _entry_points():
    """{name: parameter count} of every ``extern "C"`` function of csrc/*.cu."""
    found = {}
    for path in sorted((PKG / "csrc").glob("*.cu")):
        text = re.sub(r"//[^\n]*", "", path.read_text())
        for name, params in re.findall(r'extern\s+"C"[^(;{]*?\b(ndsm_\w+)\s*\(([^)]*)\)', text):
            params = params.strip()
            found[name] = 0 if params in ("", "void") else params.count(",") + 1
    return found


_ENTRIES = _entry_points()


def test_kernel_entry_points_are_the_ctypes_table():
    """Every C entry point of the sources has a row in the ctypes table and
    every row an entry point (a row without one fails only at load, on the
    card; an entry point without a row is dead)."""
    assert set(_ENTRIES) - set(_NOT_IN_TABLE) == set(cuda_build._SIGNATURES)


@pytest.mark.parametrize("name", sorted(cuda_build._SIGNATURES))
def test_kernel_entry_point_row_and_caller(name):
    """The row's argument count is the entry point's parameter count (a
    mismatch crashes only on the card), and a module of the package calls
    the entry point as ``lib.<name>`` or ``kernels().<name>``."""
    assert len(cuda_build._SIGNATURES[name]) == _ENTRIES.get(name), name
    if name in _NO_CALLER:
        return
    pattern = re.compile(r"\b(?:lib|kernels\(\))\." + name + r"\b")
    callers = [p for p in _modules() if p.name != "cuda_build.py"
               and pattern.search(p.read_text())]
    assert callers, f"{name}: no module of the package calls it"


def _written_positions():
    """{name: positions} of the pointers each ``extern "C"`` function of
    csrc/*.cu writes through: its pointer parameters that are not const,
    the stream aside."""
    found = {}
    for path in sorted((PKG / "csrc").glob("*.cu")):
        text = re.sub(r"//[^\n]*", "", path.read_text())
        for name, params in re.findall(r'extern\s+"C"[^(;{]*?\b(ndsm_\w+)\s*\(([^)]*)\)', text):
            ps = [q.strip() for q in params.split(",")]
            found[name] = [i for i, q in enumerate(ps)
                           if "*" in q and "const" not in q and not q.endswith("stream")]
    return found


#: Tensor methods whose result may share its argument's storage.
_VIEWS = {"view", "view_as", "reshape", "flatten", "unflatten", "squeeze", "unsqueeze",
          "select", "narrow", "transpose", "permute", "expand", "as_strided", "contiguous",
          "unbind", "chunk", "split", "detach"}


def _root(node):
    """The name an ``x``, ``x[...]`` or ``x.attr`` expression starts from."""
    while isinstance(node, (ast.Subscript, ast.Attribute)):
        node = node.value
    return node.id if isinstance(node, ast.Name) else None


def _caller_held(fn):
    """{name: the parameters it may hold} of the names in ``fn`` that may
    hold what its caller passed: its parameters, and locals bound to one, a
    view of one or either branch of a conditional of one."""
    a = fn.args
    params = [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
    params += [x.arg for x in (a.vararg, a.kwarg) if x is not None]
    held = {p: {p} for p in params}

    def sources(e):
        if isinstance(e, ast.Name):
            return held.get(e.id, set())
        if isinstance(e, ast.IfExp):
            return sources(e.body) | sources(e.orelse)
        if isinstance(e, (ast.Subscript, ast.Starred)):
            return sources(e.value)
        if isinstance(e, (ast.Tuple, ast.List)):
            return set().union(*(sources(x) for x in e.elts))
        if isinstance(e, ast.Call) and isinstance(e.func, ast.Attribute) \
                and e.func.attr in _VIEWS:
            return sources(e.func.value)
        return set()

    changed = True
    while changed:
        changed = False
        for node in ast.walk(fn):
            pairs = ([(t, node.value) for t in node.targets] if isinstance(node, ast.Assign)
                     else [(node.target, node.iter)] if isinstance(node, ast.For) else [])
            for target, value in pairs:
                got = sources(value)
                for n in ast.walk(target):
                    if got and isinstance(n, ast.Name) and not got <= held.get(n.id, set()):
                        held[n.id] = held.get(n.id, set()) | got
                        changed = True
    return held


def _kernel_writes(fn, written):
    """(line, entry point, root name) of each tensor that ``fn`` passes a
    kernel as ``<x>.data_ptr()`` at a position the kernel writes through
    (called as ``lib.<entry>`` or through a local bound to such)."""
    aliases = {}
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            names = {x.attr for x in ast.walk(node.value)
                     if isinstance(x, ast.Attribute) and x.attr in written}
            if names:
                aliases[node.targets[0].id] = names
    found = []
    for node in ast.walk(fn):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        entries = ({f.attr} if isinstance(f, ast.Attribute) and f.attr in written
                   else aliases.get(f.id, set()) if isinstance(f, ast.Name) else set())
        starred = [i for i, x in enumerate(node.args) if isinstance(x, ast.Starred)]
        for entry in entries:
            for i in written[entry]:
                assert not starred or i < starred[0], (
                    f"{fn.name}:{node.lineno}: {entry}'s written argument {i} follows a *arg")
                for c in ast.walk(node.args[i]):
                    if isinstance(c, ast.Call) and isinstance(c.func, ast.Attribute) \
                            and c.func.attr == "data_ptr":
                        found.append((node.lineno, entry, _root(c.func.value)))
    return found


def test_a_kernel_write_into_a_callers_tensor_moves_its_version():
    """A kernel writes through a raw pointer, which moves no tensor's
    version (``Tensor._version``) as an in-place torch op does.  A CUDA
    graph's replay (mg/graphs.py) skips copying in an input it holds at the
    same version, so a wrapper that has a kernel write into a tensor its
    caller passed (``df_residual_3d``'s ``r32_out``) must call
    ``torch.autograd.graph.increment_version`` on it: else a replay would
    run on the stale copy.  Tensors a wrapper makes itself need nothing."""
    written = _written_positions()
    sites, held_sites = 0, []
    for path in _modules():
        tree = ast.parse(path.read_text())
        for fn in ast.walk(tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            writes = _kernel_writes(fn, written)
            if not writes:
                continue
            held = _caller_held(fn)
            bumped = {_root(c.args[0]) for c in ast.walk(fn)
                      if isinstance(c, ast.Call) and c.args
                      and (getattr(c.func, "attr", None) == "increment_version"
                           or getattr(c.func, "id", None) == "increment_version")}
            for line, entry, name in writes:
                sites += 1
                where = f"{path.relative_to(REPO)}:{line} {fn.name}: {entry} writes {name}"
                assert name is not None, where
                if name in held:
                    held_sites.append(where)
                    assert ({name} | held[name]) & bumped, (
                        where + f", which may be the caller's {sorted(held[name])}, "
                        "with no increment_version")
    assert sites >= 20  # the scan sees the kernels' call sites
    assert any("df.py" in w and "r32" in w for w in held_sites), held_sites


def test_dist_runs_and_meshes_take_no_device_on_their_own():
    """dist= is ported: it runs on a mesh of the caller's devices.
    make_mesh(n) alone takes n CUDA devices and raises when there are
    fewer; a mesh on the CPU does not run a device="cuda" call."""
    from ndsm_tpu_torch.parallel.shard import DistConfig, make_mesh

    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(RuntimeError, match="CUDA devices"):
        make_mesh(have + 1)
    x = np.linspace(0, 1, 8)
    b = np.zeros((3, 8, 8, 8))
    dist = DistConfig(make_mesh(2, devices=["cpu"] * 2))
    ierr, A, B = ndsm_tpu_torch.vector_potential(x, x, x, b, dist=dist, device="cpu")
    assert ierr == 0 and A.shape == B.shape == (3, 8, 8, 8)
    with pytest.raises((RuntimeError, ValueError)):  # no card, or a mismatched mesh
        ndsm_tpu_torch.vector_potential(x, x, x, b, dist=dist, device="cuda")


def test_multihost_modules_leave_jax_out():
    """The multi-process modules import neither JAX nor ndsm_tpu."""
    code = ("import sys, ndsm_tpu_torch.parallel.multihost, ndsm_tpu_torch.parallel._mh_worker; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'ndsm_tpu')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(REPO), env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_multihost_mesh_takes_no_device_on_its_own():
    """make_multihost_mesh() without a card and without devices raises;
    with devices it is a (1, n) mesh of this process."""
    from ndsm_tpu_torch.parallel.multihost import make_multihost_mesh

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_multihost_mesh()
    mesh = make_multihost_mesh(devices=["cpu"] * 3)
    assert mesh.shape == (1, 3) and mesh.ranks is None
    with pytest.raises(ValueError, match="per_host"):
        make_multihost_mesh(per_host=2, devices=["cpu"] * 3)


def test_init_distributed_without_settings_is_a_no_op(monkeypatch):
    from ndsm_tpu_torch.parallel.multihost import init_distributed

    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    init_distributed()
    init_distributed()  # idempotent
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError, match="process_id"):  # a partial setting raises
        init_distributed("localhost:1", num_processes=2)
    assert not torch.distributed.is_initialized()

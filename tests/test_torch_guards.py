"""Guards of the port: it stands alone (no JAX, no ndsm_tpu), it never
hides the device or a kernel behind a fallback, and it takes every option
of the JAX package and ignores none."""

import ast
import dataclasses
import os
import pathlib
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
    The one handler allowed is the LRU cache's ``except KeyError``."""
    for path in _modules():
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.ExceptHandler):
                caught = node.type.id if isinstance(node.type, ast.Name) else None
                assert caught == "KeyError", f"{path}:{node.lineno} catches {ast.dump(node.type)}"


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

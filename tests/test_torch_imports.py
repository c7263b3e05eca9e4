"""The PyTorch port stands alone: no module of avrecode_tpu_torch (nor a
chip_*.py script, nor tools/gpu_verify.py) loads jax or any module of the
JAX package avrecode_tpu, statically or at run time, and a CUDA device is
never picked silently."""

import ast
import os
import subprocess
import sys

import pytest
import torch

import avrecode_tpu_torch
from avrecode_tpu_torch import resolve_device

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
PKG = os.path.join(ROOT, "avrecode_tpu_torch")
PY_FILES = sorted(os.path.join(d, f) for d, _, fs in os.walk(PKG)
                  for f in fs if f.endswith(".py"))
MODULES = [
    os.path.relpath(p, ROOT)[:-3].replace(os.sep, ".").removesuffix(".__init__")
    for p in PY_FILES
]
# top-level packages the port must not load: jax, and the whole JAX package
# (avrecode_tpu_torch shares its prefix, so names are compared by their root)
FORBIDDEN_ROOTS = ("jax", "jaxlib", "avrecode_tpu")
# the port's scripts outside the package: (module name, path)
SCRIPTS = [(f"chip_{n}", os.path.join(ROOT, f"chip_{n}.py"))
           for n in ("smoke", "stages", "variants", "sass", "probe")]
SCRIPTS.append(("tools.gpu_verify", os.path.join(ROOT, "tools", "gpu_verify.py")))


def _forbidden(name):
    return name.split(".")[0] in FORBIDDEN_ROOTS


def test_forbidden_names():
    assert _forbidden("jax") and _forbidden("jax.numpy")
    assert _forbidden("avrecode_tpu") and _forbidden("avrecode_tpu.utils.bitio")
    assert not _forbidden("avrecode_tpu_torch")
    assert not _forbidden("avrecode_tpu_torch.codec")


def test_every_port_module_imports_without_jax():
    """Every port module and every script of the port, imported in a fresh
    process, leave jax and the JAX package out of sys.modules."""
    code = (
        "import importlib, sys\n"
        f"for m in {MODULES + [m for m, _ in SCRIPTS]!r}:\n"
        "    importlib.import_module(m)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN_ROOTS!r})\n"
        "print(bad)\n"
        "assert not bad, bad\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    for m in ("parallel.pipeline", "codec", "host.native", "h264.stream",
              "models.trace", "utils.container", "ops._mix_tables",
              "ops.lane_decoder", "graft_entry", "parallel.mesh",
              "parallel.multihost", "parallel.ranks", "cli", "__main__"):
        assert f"avrecode_tpu_torch.{m}" in MODULES


def _imported_names(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
            yield from (f"{node.module}.{a.name}" for a in node.names)


@pytest.mark.parametrize(
    "path",
    [p for _, p in SCRIPTS] + PY_FILES,
    ids=lambda p: os.path.relpath(p, ROOT),
)
def test_no_jax_import_statement(path):
    """Static check, including imports inside functions (which the import
    test above does not execute)."""
    bad = [n for n in _imported_names(path) if _forbidden(n)]
    assert not bad, bad


def test_resolve_device_raises_without_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for dev in (None, "cuda", "cuda:0", torch.device("cuda")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device(dev)
    assert resolve_device("cpu") == torch.device("cpu")


def test_resolve_device_picks_cuda_when_present(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert resolve_device(None) == torch.device("cuda")
    assert resolve_device("cuda") == torch.device("cuda")


def test_pipeline_entries_raise_without_card(monkeypatch):
    from avrecode_tpu_torch.ops.lane_coder import encode_traces_lanes
    from avrecode_tpu_torch.parallel.pipeline import (
        device_compress, device_compress_corpus, device_decompress)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        device_compress(b"not a video")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        device_compress_corpus([b"not a video"], device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        encode_traces_lanes([], 64)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        device_decompress(b"not a container")


def test_mesh_and_rank_entries_raise_without_card(monkeypatch):
    """make_mesh, device_compress(mesh=...) on cards, multichip_step and
    dryrun_multichip need a card unless the CPU is asked for."""
    from avrecode_tpu_torch.graft_entry import dryrun_multichip
    from avrecode_tpu_torch.ops.lane_decoder import decode_streams_lanes
    from avrecode_tpu_torch.parallel import multihost, ranks
    from avrecode_tpu_torch.parallel.pipeline import (
        device_compress, make_mesh, multichip_step)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for args in ((), (4,), (2, "cuda:0"), (None, "cuda")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh(*args)
    cards = (torch.device("cuda", 0), torch.device("cuda", 0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        device_compress(b"not a video", mesh=cards)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        decode_streams_lanes([], [[]], [], mesh=cards)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        multichip_step(*[[[0]]] * 5)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun_multichip(2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ranks.rank_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ranks.pick_backend(2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        multihost.init_distributed("127.0.0.1:1", 2, 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ranks.run_ranks(test_version, 2)
    assert make_mesh(2, device="cpu") == (torch.device("cpu"),) * 2


def test_cli_is_host_code():
    """The command line, --hosts included, starts without loading torch:
    GOP sharding is host code."""
    res = subprocess.run(
        [sys.executable, "-c",
         "import sys; sys.argv = ['x']\n"
         "import avrecode_tpu_torch.cli\n"
         "import avrecode_tpu_torch.parallel.multihost\n"
         "print(sorted(m for m in sys.modules if m.split('.')[0] == 'torch'))"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "[]", res.stdout


def test_version():
    assert avrecode_tpu_torch.__version__

"""The port's boundary: ``sparknet_tpu_torch`` and ``chip_smoke.py`` import
neither ``jax`` nor anything of the JAX package ``sparknet_tpu``, and the
port's entry points refuse to run without a CUDA card unless the caller
asks for the CPU.

Note the names: the port's package starts with the letters
``sparknet_tpu``, so "of the JAX package" means the module
``sparknet_tpu`` itself or a name under ``sparknet_tpu.``.
"""

import ast
import json
import os
import pkgutil
import shutil
import subprocess
import sys

import pytest
import torch

import sparknet_tpu_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_DIR = os.path.dirname(sparknet_tpu_torch.__file__)
ALEXNET = os.path.join(PORT_DIR, "models", "prototxt", "bvlc_alexnet_deploy.prototxt")


def _of_jax(name: str) -> bool:
    """Is ``name`` JAX, or a module of the JAX package?"""
    return (name == "jax" or name.startswith("jax.") or name == "sparknet_tpu"
            or name.startswith("sparknet_tpu."))


def test_of_jax_tells_the_port_from_the_jax_package():
    assert _of_jax("sparknet_tpu") and _of_jax("sparknet_tpu.nets.layers")
    assert _of_jax("jax") and _of_jax("jax.numpy")
    assert not _of_jax("sparknet_tpu_torch") and not _of_jax("sparknet_tpu_torch.ops.lrn")
    assert not _of_jax("jaxlib_free_module")


_CHILD = r"""
import importlib, json, pkgutil, sys
import sparknet_tpu_torch
names = [m.name for m in pkgutil.walk_packages(sparknet_tpu_torch.__path__,
                                               "sparknet_tpu_torch.")]
for name in names:
    importlib.import_module(name)
from sparknet_tpu_torch.tools import serve
record = serve.main(["--model", sys.argv[1], "--device", "cpu", "--bench", "4",
                     "--buckets", "1,4", "--port", "0"])
print(json.dumps({"modules": names, "loaded": sorted(sys.modules),
                  "errors": record["errors"]}))
"""


def test_port_imports_no_jax_in_a_fresh_process():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run(
        [sys.executable, "-c", _CHILD, ALEXNET], capture_output=True, text=True,
        env=env, cwd=REPO, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["errors"] == 0
    assert "sparknet_tpu_torch.serve.server" in out["modules"]
    assert "sparknet_tpu_torch.ops.lrn" in out["modules"]
    leaked = [m for m in out["loaded"] if _of_jax(m)]
    assert not leaked, leaked


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def _sources():
    yield os.path.join(REPO, "chip_smoke.py")
    for root, _, files in os.walk(PORT_DIR):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)


@pytest.mark.parametrize("path", sorted(_sources()), ids=lambda p: os.path.relpath(p, REPO))
def test_source_imports_nothing_of_jax(path):
    bad = [name for name in _imports(path) if _of_jax(name)]
    assert not bad, f"{os.path.relpath(path, REPO)} imports {bad}"


def test_chip_smoke_alone_fails_without_the_port(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "chip_smoke.py"], capture_output=True,
                          text=True, cwd=tmp_path, env=env, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card: the default device works")


def test_entry_points_raise_without_a_card(no_card, tmp_path):
    from sparknet_tpu_torch.device import resolve_device
    from sparknet_tpu_torch.nets.torchnet import TorchNet
    from sparknet_tpu_torch.proto import caffe_pb
    from sparknet_tpu_torch.serve.engine import InferenceEngine
    from sparknet_tpu_torch.tools import serve

    net = caffe_pb.load_net(ALEXNET)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TorchNet(net, "TEST")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        InferenceEngine.from_files(ALEXNET)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--model", ALEXNET, "--bench", "1", "--port", "0"])
    # asked for, the CPU works
    assert TorchNet(net, "TEST", device="cpu").device.type == "cpu"
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("meta")


def test_package_sources_ship_with_the_package():
    """The kernel source and the deploy prototxt live inside the package
    (and in its package data), so a run from the repo root finds them."""
    from sparknet_tpu_torch.ops import _build

    assert _build.sources() == ["lrn"]
    assert os.path.isfile(ALEXNET)
    assert _build.BUILD_DIR == os.path.join(PORT_DIR, "_build")
    ignored = open(os.path.join(REPO, ".gitignore")).read().split()
    assert "sparknet_tpu_torch/_build/" in ignored
    names = {m.name for m in pkgutil.iter_modules(sparknet_tpu_torch.__path__)}
    assert {"ops", "nets", "proto", "serve", "tools", "telemetry"} <= names

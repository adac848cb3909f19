"""ImageNetApp's other three architectures on the CPU, through ``main``.

``--arch googlenet``, ``resnet50`` and ``vgg16`` each train one
iteration at full width (batch 2, 224x224 crops of the synthetic
ImageNet stand-in, ``--device cpu``) through a short solver over the
port's own train_val prototxt, then test one batch. The test outputs are
the nets' own loss and Accuracy tops, as the JAX app prints them:
GoogLeNet's three heads (``loss1/``, ``loss2/``, ``loss3/`` each with
``loss``, ``top-1`` and ``top-5``), the others' ``loss/loss``,
``loss/top-1`` and ``loss/top-5``; all finite. ResNet-50's solverstate
carries its 53 BatchNorm states (finite, variance >= 0) and they moved
from their initial zeros and ones; ``--bf16`` trains GoogLeNet (LRN,
Concat) and ResNet-50 (BatchNorm, Scale, Eltwise) too. Without
``--device cpu`` and without a card, each raises.
"""

import re

import numpy as np
import pytest
import torch

from sparknet_tpu_torch import models
from sparknet_tpu_torch.apps import imagenet_app
from sparknet_tpu_torch.solver import snapshot as tsnapshot

ARCHS = {
    "googlenet": (models.GOOGLENET_TRAIN_VAL, 13_378_280,
                  [f"loss{i}/{k}" for i in (1, 2, 3) for k in ("loss", "top-1", "top-5")]),
    "resnet50": (models.RESNET50_TRAIN_VAL, 25_557_032,
                 ["loss/loss", "loss/top-1", "loss/top-5"]),
    "vgg16": (models.VGG16_TRAIN_VAL, 138_357_544,
              ["loss/loss", "loss/top-1", "loss/top-5"]),
}


def _solver(tmp_path, arch, snapshot):
    path = tmp_path / f"{arch}_solver.prototxt"
    text = (f'net: "{ARCHS[arch][0]}"\n'
            "test_iter: 1\ntest_interval: 100\ntest_initialization: false\n"
            'base_lr: 0.01\nlr_policy: "step"\ngamma: 0.1\nstepsize: 100000\n'
            "display: 1\nmax_iter: 100\nmomentum: 0.9\nweight_decay: 0.0005\n")
    if snapshot:
        text += f'snapshot: 100\nsnapshot_prefix: "{tmp_path / arch}"\n'
    path.write_text(text)
    return str(path)


def _argv(tmp_path, arch, snapshot=False):
    return ["--arch", arch, "--synthetic", "--synthetic-n", "8", "--batch-size", "2",
            "--max-iter", "1", "--solver", _solver(tmp_path, arch, snapshot)]


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_imagenet_app_trains_each_zoo_arch_on_the_cpu(arch, tmp_path, capsys):
    _, count, tops = ARCHS[arch]
    last_test = imagenet_app.main(_argv(tmp_path, arch, snapshot=arch == "resnet50")
                                  + ["--device", "cpu"])
    out = capsys.readouterr().out
    assert f"params={count}" in out and "device=cpu" in out
    assert re.search(r"^Iteration 1, loss = ", out, re.M)
    assert "speed: steps/s=" in out and "Optimization Done. 1 iters" in out
    assert sorted(last_test) == sorted(tops)
    assert all(np.isfinite(v) for v in last_test.values())
    for k in tops:
        assert re.search(rf"Test net output: {re.escape(k)} = \S+", out), k
    if arch == "resnet50":
        st = tsnapshot.load_state(str(tmp_path / "resnet50_iter_1.solverstate.npz"))
        assert st["it"] == 1 and len(st["state"]) == 53
        for layer, e in st["state"].items():
            assert np.all(np.isfinite(e["mean"])) and np.all(np.isfinite(e["var"])), layer
            assert np.all(e["var"] >= 0), layer
        assert np.any(st["state"]["bn_conv1"]["mean"] != 0)
        assert np.any(st["state"]["bn_conv1"]["var"] != 1)


@pytest.mark.parametrize("arch", ["googlenet", "resnet50"])
def test_imagenet_app_trains_bf16_on_the_cpu(arch, tmp_path, capsys):
    last_test = imagenet_app.main(_argv(tmp_path, arch) + ["--device", "cpu", "--bf16"])
    assert "Optimization Done. 1 iters" in capsys.readouterr().out
    assert sorted(last_test) == sorted(ARCHS[arch][2])
    assert all(np.isfinite(v) for v in last_test.values())


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_imagenet_app_zoo_arch_needs_a_card_unless_told_cpu(arch, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card: the default device works")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        imagenet_app.main(_argv(tmp_path, arch))

"""The port's own prototxt parser and Caffe messages
(``sparknet_tpu_torch/proto``) against the JAX package's.

Every prototxt the repo ships, and the port's AlexNet deploy net, must
parse to the same fields and the same nets in both packages; the
protobuf text-format rules (singular fields last-wins, repeated fields
accumulate) and the deploy inputs are pinned on small texts.
"""

import glob
import os

import pytest

from sparknet_tpu.proto import caffe_pb as jpb
from sparknet_tpu.proto import textformat as jtf
from sparknet_tpu_torch.models import ALEXNET_DEPLOY
from sparknet_tpu_torch.proto import caffe_pb as tpb
from sparknet_tpu_torch.proto import textformat as ttf

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROTOTXTS = sorted(glob.glob(os.path.join(REPO, "sparknet_tpu", "models",
                                          "prototxt", "*.prototxt")))
PROTOTXTS.append(ALEXNET_DEPLOY)


def _ids(path):
    return os.path.relpath(path, REPO)


@pytest.mark.parametrize("path", PROTOTXTS, ids=_ids)
def test_file_parses_to_the_same_fields(path):
    assert ttf.parse_file(path).to_dict() == jtf.parse_file(path).to_dict()


def _net_summary(net):
    return {
        "name": net.name,
        "inputs": net.inputs,
        "input_shapes": net.input_shapes,
        "phases": {
            phase: [(l.name, l.type, l.bottom, l.top, l.loss_weight,
                     [(p.lr_mult, p.decay_mult) for p in l.params])
                    for l in net.layers_for_phase(phase)]
            for phase in ("TRAIN", "TEST")
        },
    }


@pytest.mark.parametrize("path", [p for p in PROTOTXTS if "solver" not in p],
                         ids=_ids)
def test_net_reads_the_same(path):
    assert _net_summary(tpb.load_net(path)) == _net_summary(jpb.load_net(path))


def test_singular_last_wins_and_repeated_accumulate():
    text = 'name: "a" name: "b" bottom: "x" bottom: "y" p { v: 1 } p { v: 2 }'
    for tf in (ttf, jtf):
        m = tf.parse(text)
        assert m.get("name") == "b"
        assert m.get_all("bottom") == ["x", "y"]
        assert [q.get("v") for q in m.get_all("p")] == [1, 2]
        assert m.get("p").get("v") == 2


def test_deploy_inputs_and_legacy_input_dim():
    shaped = ('input: "data" input_shape { dim: 1 dim: 3 dim: 227 dim: 227 } '
              'layer { name: "r" type: "ReLU" bottom: "data" top: "data" }')
    legacy = 'input: "data" input_dim: 2 input_dim: 3 input_dim: 8 input_dim: 8'
    for text, shape in ((shaped, [1, 3, 227, 227]), (legacy, [2, 3, 8, 8])):
        net = tpb.load_net(text, is_path=False)
        assert net.inputs == ["data"] and net.input_shapes == [shape]
        assert _net_summary(net) == _net_summary(jpb.load_net(text, is_path=False))


def test_phase_include_and_exclude():
    text = ('layer { name: "tr" type: "ReLU" include { phase: TRAIN } } '
            'layer { name: "te" type: "ReLU" exclude { phase: TRAIN } } '
            'layer { name: "both" type: "ReLU" }')
    net = tpb.load_net(text, is_path=False)
    assert [l.name for l in net.layers_for_phase("TRAIN")] == ["tr", "both"]
    assert [l.name for l in net.layers_for_phase("TEST")] == ["te", "both"]


def test_parse_error_on_unbalanced_braces():
    with pytest.raises(ttf.ParseError):
        ttf.parse('layer { name: "x" ')

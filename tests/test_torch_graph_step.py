"""The captured train step (``Solver.step`` as one CUDA graph), without JAX.

This file imports nothing of JAX, so it also runs on a machine with a
card and no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_graph_step.py

On the CPU the fused step runs eagerly and captures nothing; the launch
counters' registry names the six kernel wrappers. The tests marked
``cuda`` skip without a card. There, a small net with Dropout and a rate
that turns every 3 iterations trains 8 iterations through the graph
and 8 through the same step run eagerly (``SPARKNET_FUSED_STEP=0``): params,
slots and the generator's state bit for bit (the same kernels on the
same inputs, the masks drawn from the registered generator); a step
that reads the card from the host cannot be captured and raises, naming
the cause; a thread that stages batches on its own stream during the
capture leaves it alone; a new batch signature captures a new graph.
"""

import itertools
import threading

import numpy as np
import pytest
import torch

from sparknet_tpu_torch.ops import launch_counters
from sparknet_tpu_torch.proto import caffe_pb
from sparknet_tpu_torch.solver.trainer import WARMUP_STEPS, Solver

NET = """
name: "tiny"
layer { name: "d" type: "Input" top: "data" top: "label" }
layer { name: "ip1" type: "InnerProduct" bottom: "data" top: "ip1"
        inner_product_param { num_output: 32 weight_filler { type: "xavier" } } }
layer { name: "relu1" type: "ReLU" bottom: "ip1" top: "ip1" }
layer { name: "drop" type: "Dropout" bottom: "ip1" top: "ip1" }
layer { name: "ip2" type: "InnerProduct" bottom: "ip1" top: "ip2"
        inner_product_param { num_output: 4 weight_filler { type: "xavier" } } }
layer { name: "loss" type: "SoftmaxWithLoss" bottom: "ip2" bottom: "label" top: "loss" }
"""
SOLVER = ("base_lr: 0.1 momentum: 0.9 lr_policy: 'step' gamma: 0.5 stepsize: 3 "
          "weight_decay: 0.001")


def _solver(device, batch=8, **kw):
    return Solver(caffe_pb.load_solver(SOLVER, is_path=False),
                  {"data": (batch, 16), "label": (batch,)},
                  net_param=caffe_pb.load_net(NET, is_path=False), seed=3, device=device,
                  **kw)


def _feed(batch=8):
    rng = np.random.default_rng(5)
    while True:
        yield {"data": rng.normal(size=(batch, 16)).astype(np.float32),
               "label": rng.integers(0, 4, size=(batch,)).astype(np.int32)}


def _leaves(s):
    trees = [s.params, s.state, *s.opt_state.values()]
    return [t for tree in trees for e in tree.values() for t in e.values()]


def test_launch_counters_name_the_six_kernel_wrappers():
    assert [fn.__name__ for fn in launch_counters()] == [
        "lrn_rows", "lrn_rows_train", "lrn_rows_bwd",
        "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"]
    assert all(isinstance(fn.launches, int) for fn in launch_counters())


def test_fused_step_on_the_cpu_captures_nothing():
    s = _solver("cpu")
    s.step(_feed(), WARMUP_STEPS + 2)
    assert s._graph is None and s._it_dev.device.type == "cpu" and int(s._it_dev) == 4


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the step is captured as a CUDA graph")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_captured_step_is_the_eager_step_on_card(cuda_device):
    graph, eager = _solver(cuda_device), _solver(cuda_device)
    eager._fuse_host = False
    mg, me = graph.step(_feed(), 8), eager.step(_feed(), 8)
    assert graph._graph is not None and graph._graph.graph is not None
    assert graph.iter == eager.iter == 8 and int(graph._it_dev) == 8
    assert torch.equal(mg["loss"], me["loss"])
    for a, b in zip(_leaves(graph), _leaves(eager)):
        assert torch.equal(a, b)
    assert torch.equal(graph.rng.get_state(), eager.rng.get_state())
    # scan_steps: one copy, then replays of the same graph
    batch = next(_feed())
    graph.scan_steps(batch, 4)
    eager.step(itertools.repeat(batch), 4)
    for a, b in zip(_leaves(graph), _leaves(eager)):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_a_step_that_reads_the_card_cannot_be_captured_and_raises(cuda_device):
    def host_read(batch):
        if float(batch["data"].sum()) > 1e9:  # a host read inside the step
            raise AssertionError("unreachable")
        return batch

    s = _solver(cuda_device, batch_transform=host_read)
    feed = _feed()
    s.step(feed, WARMUP_STEPS)  # the warm-up runs eagerly
    with pytest.raises(RuntimeError, match="capturing the train step as a CUDA graph"):
        s.step(feed, 1)


@pytest.mark.cuda
def test_a_staging_thread_on_another_stream_leaves_the_capture_alone(cuda_device):
    """A feed's staging thread uploads and waits on its own events while
    the step is captured (the apps' ``--prefetch``)."""
    stop = threading.Event()

    def stage():
        stream = torch.cuda.Stream(cuda_device)
        host = torch.ones(1 << 20).pin_memory()
        while not stop.is_set():
            with torch.cuda.stream(stream):
                host.to(cuda_device, non_blocking=True)
                done = torch.cuda.Event()
                done.record(stream)
            done.synchronize()

    thread = threading.Thread(target=stage, daemon=True)
    thread.start()
    try:
        s = _solver(cuda_device)
        s.step(_feed(), WARMUP_STEPS + 3)
        assert s._graph.graph is not None
    finally:
        stop.set()
        thread.join(timeout=30)
    assert not thread.is_alive()


@pytest.mark.cuda
def test_a_new_batch_signature_captures_a_new_graph(cuda_device):
    s = _solver(cuda_device)
    s.step(_feed(), WARMUP_STEPS + 1)
    first = s._graph
    assert first.graph is not None
    wide = next(_feed())
    wide["data"] = wide["data"].astype(np.float64)  # another dtype: another signature
    s.step(iter([wide]), 1)
    assert s._graph is not first and s._graph.graph is None and s._graph.warm == 1

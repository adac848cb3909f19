"""The port's solver math and ``mxu_dot`` against the JAX package.

- ``SolverParameter``: every field parsed as the JAX parser parses it.
- ``learning_rate``: every lr policy (and ``warmup_iter``) at several
  iterations; both compute in f32, rtol 1e-6.
- ``make_update_fn``: three updates of each of the seven solver types
  on random trees, with ``lr_mult`` / ``decay_mult``, L2 or L1 and
  global-norm clipping; a ``step`` lr policy that changes the rate every
  iteration, so Caffe's rate-inside-the-momentum rule is exercised.
  Params and every slot: f32 rtol 1e-5, atol 1e-6 (the same f32
  arithmetic, fused in another order).
- ``mxu_dot``'s backward contract: f32 rtol 1e-6, atol 1e-6 (sums of 16
  products near zero); bf16 operands: dx and dw within one bf16 ulp of
  the f32-computed products of the bf16-rounded cotangent, in both
  packages.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sparknet_tpu.ops.matmul import mxu_dot as jmxu_dot
from sparknet_tpu.proto import caffe_pb as jpb
from sparknet_tpu.solver import caffe_solver as JS
from sparknet_tpu_torch.ops.matmul import mxu_dot
from sparknet_tpu_torch.proto import caffe_pb as tpb
from sparknet_tpu_torch.solver import caffe_solver as TS

UPDATE_TOL = dict(rtol=1e-5, atol=1e-6)


# ------------------------------------------------------------ SolverParameter
SOLVER_TEXTS = {
    "zoo_alexnet": open(
        "sparknet_tpu/models/prototxt/bvlc_alexnet_solver.prototxt").read(),
    "every_field": """
        train_net: "a.prototxt" test_net: "b.prototxt" test_net: "c.prototxt"
        test_iter: 3 test_iter: 4 test_interval: 7 base_lr: 0.3
        lr_policy: "multistep" gamma: 0.2 power: 1.5 stepsize: 9
        stepvalue: 5 stepvalue: 11 max_iter: 40 momentum: 0.8 momentum2: 0.99
        rms_decay: 0.9 delta: 1e-6 weight_decay: 0.01
        regularization_type: "L1" clip_gradients: 2.5 iter_size: 2 display: 3
        snapshot: 10 snapshot_prefix: "snap/x" solver_mode: CPU
        type: "Adam" random_seed: 17 test_initialization: false
        average_loss: 5 warmup_iter: 6""",
    "solver_type_alias": 'net: "n.prototxt" solver_type: NESTEROV',
}


@pytest.mark.parametrize("name", sorted(SOLVER_TEXTS))
def test_solver_parameter_matches_jax(name):
    text = SOLVER_TEXTS[name]
    j = jpb.load_solver(text, is_path=False)
    t = tpb.load_solver(text, is_path=False)
    for f in dataclasses.fields(j):
        if f.name in ("raw", "net_param"):
            continue
        assert getattr(t, f.name) == getattr(j, f.name), f.name


# -------------------------------------------------------------- learning_rate
LR_POLICIES = {
    "fixed": 'lr_policy: "fixed"',
    "step": 'lr_policy: "step" gamma: 0.5 stepsize: 100',
    "exp": 'lr_policy: "exp" gamma: 0.99',
    "inv": 'lr_policy: "inv" gamma: 0.001 power: 0.75',
    "multistep": 'lr_policy: "multistep" gamma: 0.3 stepvalue: 50 stepvalue: 200',
    "multistep_none": 'lr_policy: "multistep" gamma: 0.3',
    "poly": 'lr_policy: "poly" power: 2.0 max_iter: 1000',
    "sigmoid": 'lr_policy: "sigmoid" gamma: -0.05 stepsize: 150',
    "step_warmup": 'lr_policy: "step" gamma: 0.5 stepsize: 100 warmup_iter: 10',
    "poly_warmup": 'lr_policy: "poly" power: 1.0 max_iter: 300 warmup_iter: 40',
}
ITERS = (0, 1, 5, 9, 10, 49, 50, 99, 100, 101, 250, 999, 1000, 1200)


@pytest.mark.parametrize("policy", sorted(LR_POLICIES))
def test_learning_rate_matches_jax(policy):
    text = f"base_lr: 0.01 {LR_POLICIES[policy]}"
    j = jpb.load_solver(text, is_path=False)
    t = tpb.load_solver(text, is_path=False)
    got = [TS.learning_rate(t, it) for it in ITERS]
    want = [float(JS.learning_rate(j, jnp.asarray(it, jnp.int32))) for it in ITERS]
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_unknown_policy_and_solver_type_raise():
    with pytest.raises(NotImplementedError, match="lr_policy"):
        TS.learning_rate(tpb.load_solver('lr_policy: "cosine"', is_path=False), 0)
    with pytest.raises(NotImplementedError, match="solver type"):
        TS.make_update_fn(tpb.load_solver('type: "LAMB"', is_path=False))


# --------------------------------------------------------------------- update
SHAPES = {"conv1": {"weight": (4, 3, 3, 3), "bias": (4,)},
          "fc": {"weight": (12, 5), "bias": (5,)}}
LR_MULTS = {"conv1": {"weight": 1.0, "bias": 2.0}, "fc": {"weight": 1.5, "bias": 0.5}}
DECAY_MULTS = {"conv1": {"weight": 1.0, "bias": 0.0}, "fc": {"weight": 2.0, "bias": 0.0}}

UPDATE_CASES = {
    "sgd_l2": 'type: "SGD" momentum: 0.9 weight_decay: 0.0005',
    "sgd_l1": 'type: "SGD" momentum: 0.9 weight_decay: 0.01 regularization_type: "L1"',
    "sgd_clip": 'type: "SGD" momentum: 0.9 weight_decay: 0.0005 clip_gradients: 0.5',
    "nesterov": 'type: "Nesterov" momentum: 0.95 weight_decay: 0.001',
    "adam": 'type: "Adam" momentum: 0.9 momentum2: 0.999 delta: 1e-8 weight_decay: 0.01',
    "adamw_clip": 'type: "AdamW" momentum: 0.9 momentum2: 0.99 weight_decay: 0.05 '
                  'clip_gradients: 1.0',
    "adagrad": 'type: "AdaGrad" delta: 1e-6 weight_decay: 0.001',
    "rmsprop_l1": 'type: "RMSProp" rms_decay: 0.95 delta: 1e-6 weight_decay: 0.001 '
                  'regularization_type: "L1"',
    "adadelta_clip": 'type: "AdaDelta" momentum: 0.95 delta: 1e-6 weight_decay: 0.001 '
                     'clip_gradients: 2.0',
}


def _tree(rng, scale=1.0):
    return {layer: {n: (scale * rng.normal(size=s)).astype(np.float32)
                    for n, s in e.items()} for layer, e in SHAPES.items()}


def _torch_tree(tree):
    return {layer: {n: torch.from_numpy(a.copy()) for n, a in e.items()}
            for layer, e in tree.items()}


def _assert_tree_close(got, want, what):
    for layer, e in want.items():
        for n, a in e.items():
            np.testing.assert_allclose(got[layer][n].numpy(), np.asarray(a),
                                       err_msg=f"{what} {layer}.{n}", **UPDATE_TOL)


@pytest.mark.parametrize("case", sorted(UPDATE_CASES))
def test_update_matches_jax(case):
    text = f'base_lr: 0.1 lr_policy: "step" gamma: 0.5 stepsize: 1 {UPDATE_CASES[case]}'
    jsp = jpb.load_solver(text, is_path=False)
    tsp = tpb.load_solver(text, is_path=False)
    rng = np.random.default_rng(0)
    params = _tree(rng)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    tparams = _torch_tree(params)
    jopt = JS.init_opt_state(jsp, jparams)
    topt = TS.init_opt_state(tsp, tparams)
    assert set(topt) == set(jopt) == set(TS.opt_state_keys(tsp))
    jupdate = JS.make_update_fn(jsp, LR_MULTS, DECAY_MULTS)
    tupdate = TS.make_update_fn(tsp, LR_MULTS, DECAY_MULTS)
    for it in range(3):
        grads = _tree(rng, scale=2.0)
        tgrads = _torch_tree(grads)
        jparams, jopt = jupdate(jparams, jax.tree_util.tree_map(jnp.asarray, grads),
                                jopt, jnp.asarray(it, jnp.int32))
        tparams, topt = tupdate(tparams, tgrads, topt, it)
        _assert_tree_close(tparams, jparams, f"step {it} params")
        for slot in jopt:
            _assert_tree_close(topt[slot], jopt[slot], f"step {it} slot {slot}")
        # the grads are the caller's: left as they were
        _assert_tree_close(tgrads, grads, "grads")


def test_mults_for_params_default_to_one():
    params = _torch_tree(_tree(np.random.default_rng(0)))
    lr, dec = TS.mults_for_params(params, {"conv1": {"weight": (1.0, 1.0), "bias": (2.0, 0.0)}})
    assert lr == {"conv1": {"weight": 1.0, "bias": 2.0}, "fc": {"weight": 1.0, "bias": 1.0}}
    assert dec == {"conv1": {"weight": 1.0, "bias": 0.0}, "fc": {"weight": 1.0, "bias": 1.0}}


# -------------------------------------------------------------------- mxu_dot
def _bf16_ulp(ref: np.ndarray) -> np.ndarray:
    _, e = np.frexp(np.abs(ref))
    return np.ldexp(1.0, e - 8)


def _bf16_round(a: np.ndarray) -> np.ndarray:
    return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16).float().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mxu_dot_forward_and_backward_contract(dtype):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(4, 3, 16)).astype(np.float32)
    w = rng.normal(size=(16, 8)).astype(np.float32)
    g = rng.normal(size=(4, 3, 8)).astype(np.float32)
    tdtype = getattr(torch, dtype)
    xt = torch.from_numpy(x).to(tdtype).requires_grad_(True)
    wt = torch.from_numpy(w).to(tdtype).requires_grad_(True)
    y = mxu_dot(xt, wt)
    assert y.dtype == torch.float32
    dx, dw = torch.autograd.grad(y, (xt, wt), torch.from_numpy(g))
    assert dx.dtype == tdtype and dw.dtype == tdtype
    jx = jnp.asarray(x, getattr(jnp, dtype))
    jw = jnp.asarray(w, getattr(jnp, dtype))
    jy, vjp = jax.vjp(jmxu_dot, jx, jw)
    jdx, jdw = vjp(jnp.asarray(g))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), rtol=1e-6, atol=1e-6)
    if dtype == "float32":
        np.testing.assert_allclose(dx.numpy(), np.asarray(jdx), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(dw.numpy(), np.asarray(jdw), rtol=1e-6, atol=1e-6)
        return
    # bf16: the cotangent is rounded to bf16 first; both products are then
    # those of f32 accumulation, rounded once to bf16
    xb, wb, gb = _bf16_round(x), _bf16_round(w), _bf16_round(g)
    want_dx = (gb.astype(np.float64) @ wb.T.astype(np.float64))
    want_dw = xb.reshape(-1, 16).T.astype(np.float64) @ gb.reshape(-1, 8).astype(np.float64)
    for got, want in ((dx, want_dx), (dw, want_dw),
                      (np.asarray(jdx, np.float32), want_dx),
                      (np.asarray(jdw, np.float32), want_dw)):
        got = got.float().numpy() if isinstance(got, torch.Tensor) else got
        err = np.abs(got - want)
        assert np.all(err <= _bf16_ulp(want)), float(err.max())

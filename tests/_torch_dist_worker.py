"""One rank of the port's multi-process tests, and the launcher that
starts them.

    SPARKNET_COORDINATOR=127.0.0.1:P SPARKNET_NUM_PROCESSES=N \\
    SPARKNET_PROCESS_ID=r python tests/_torch_dist_worker.py SPEC.json

Each rank joins the job through ``multihost.initialize(device="cpu")``
(gloo), runs the spec's jobs in order and writes what each one produced
to ``<out>/<job name>.r<rank>.npz``: a flat npz of ``params/<layer>/<name>``
(the JAX package's layout), ``state/...``, ``slots/<slot>/...`` (this
rank's rows), ``loss``, ``test/<metric>`` and the params' ``hash``. The
jobs:

- ``solver``: a ``ParallelSolver`` over the processes (``mode``,
  ``tau``, ``compress``, ``bucket_mb``, ``comm``; ``overlap: false``
  starts the same buckets after the backward; ``env`` set first) from the given weights (JAX layout) or a solverstate
  (``restore``), stepped on rank r's rows of each global batch (the
  rows ``local_sgd.worker_rows`` gives worker r of the same global
  batch), then tested on its rows of the test batches and saved
  (``save``, a collective); with ``first``, the solver after its first
  step goes to ``<out>/<first>.r<rank>.npz``. It also records each
  round's next τ (``taus``) and, for each sync step that reduced inside
  the backward, how many buckets had started when the backward ended
  (``in_backward``, of ``buckets``);
- ``bert``: the same over ``BertMLM`` (a ``bert_tiny`` with the job's
  ``cfg`` overrides, ``seq`` and ``preds``), from JAX-layout weights;
- ``bn``: one BatchNorm then Scale over rank r's rows under the
  process group (the sync step's global statistics), its output, new
  state and the gradients of ``sum(y * dy)``;
- ``stall``: one sync step of a tiny net, then rank 1 stops itself
  (SIGSTOP: a wedged host whose sockets stay open) while rank 0 steps on
  into the next all-reduce, where only the heartbeat can end it;
- ``resume``: ``--auto-resume``'s choice over the processes, each rank
  looking under its own prefix (``prefixes[rank]``): the path it
  resolved, then the iteration a sync ``ParallelSolver`` of a tiny net
  restored from it, or the ``FileNotFoundError`` it raised, to
  ``<out>/<name>.r<rank>.json``.

Imports no JAX: the tests compare the files with their oracles.
"""

import hashlib
import itertools
import json
import os
import signal
import socket
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# The launches' ports come from below the kernel's ephemeral range
# (32768-60999 by default), where no socket bound to port 0 and no
# outgoing connection lands, from a block of ports of their own for each
# xdist worker, taken in turn: no other test's process picks one between
# its choice here and rank 0's bind. A port some other program holds
# anyway makes rank 0 fail with EADDRINUSE, and the launch is retried on
# the next ports, at most PORT_ATTEMPTS times.
PORT_BASE, PORT_BLOCK, PORT_ATTEMPTS = 20000, 1000, 3
# seconds a rank waits for its peers to join, and in any collective
# (multihost.initialize's SPARKNET_INIT_TIMEOUT): a rank that never joins
# fails the launch in this time, not at the launch's timeout
INIT_TIMEOUT = "60"
# seconds a launch of the tests may take: each took 5.5-9.8 s under the
# suite's `-n 6` on an 8-core machine (<tmp>/launches.log)
LAUNCH_TIMEOUT = 120
_taken = itertools.count()


def free_port(n: int = 1) -> int:
    """The first of ``n`` consecutive ports, free now, from this xdist
    worker's block (see PORT_BASE)."""
    worker = os.environ.get("PYTEST_XDIST_WORKER", "")
    block = int(worker[2:]) + 1 if worker[2:].isdigit() else 0
    base = PORT_BASE + (block % 12) * PORT_BLOCK
    for _ in range(PORT_BLOCK):
        first = base + (next(_taken) * n) % (PORT_BLOCK - n)
        try:
            for port in range(first, first + n):
                with socket.socket() as s:
                    s.bind(("127.0.0.1", port))
        except OSError:
            continue
        return first
    raise RuntimeError(f"no {n} free consecutive ports in {base}..{base + PORT_BLOCK}")


def _port_taken(logs) -> bool:
    return any("EADDRINUSE" in log or "ddress already in use" in log for log in logs)


def launch(cmd, world, tmp, timeout, extra_env=None, wait_for=None):
    """Start ``cmd`` as ``world`` ranks through the launch variables,
    each in its own session with its output in ``tmp``, and wait until
    the ranks ``wait_for`` (default: all) have exited, one rank has
    failed (its peers cannot finish without it) or ``timeout`` seconds
    have passed; then kill what is left. Returns ``[(returncode,
    output)]`` by rank; a rank that was killed has returncode None and
    its output says why. Each attempt's seconds go to
    ``<tmp>/launches.log``."""
    for attempt in range(PORT_ATTEMPTS):
        res = _launch_once(cmd, world, tmp, timeout, extra_env, wait_for)
        if not (_port_taken(log for _, log in res) and attempt + 1 < PORT_ATTEMPTS):
            return res


def _launch_once(cmd, world, tmp, timeout, extra_env, wait_for):
    port = free_port(2)
    env = dict(os.environ)
    env.update(
        SPARKNET_COORDINATOR=f"127.0.0.1:{port}",
        SPARKNET_NUM_PROCESSES=str(world),
        SPARKNET_HEARTBEAT_PORT=str(port + 1),
        SPARKNET_INIT_TIMEOUT=INIT_TIMEOUT,
        PYTHONPATH=os.pathsep.join([REPO] + [p for p in env.get("PYTHONPATH", "").split(
            os.pathsep) if p]),
        OMP_NUM_THREADS="1",
    )
    env.update(extra_env or {})
    procs, logs = [], []
    t0 = time.monotonic()
    why = "timed out"
    try:
        for r in range(world):
            log = open(os.path.join(tmp, f"rank{r}.log"), "w+")
            logs.append(log)
            procs.append(subprocess.Popen(
                cmd, env={**env, "SPARKNET_PROCESS_ID": str(r)}, cwd=tmp, stdout=log,
                stderr=subprocess.STDOUT, start_new_session=True))
        waited = procs if wait_for is None else [procs[r] for r in wait_for]
        deadline = t0 + timeout
        while time.monotonic() < deadline:
            if all(p.poll() is not None for p in waited):
                why = "the ranks waited for had exited"
                break
            failed = [r for r, p in enumerate(procs) if p.poll() not in (None, 0)]
            if failed:
                why = f"rank(s) {failed} failed first"
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()
        elapsed = time.monotonic() - t0
        out = []
        for p, log in zip(procs, logs):
            log.seek(0)
            text = log.read()
            log.close()
            killed = p.returncode is None or p.returncode < 0
            if killed:
                text += (f"\n[launcher] killed after {elapsed:.1f} s: {why} (timeout "
                         f"{timeout} s)\n")
            out.append((None if killed else p.returncode, text))
        with open(os.path.join(tmp, "launches.log"), "a") as f:
            f.write(f"{world} ranks, port {port}: {elapsed:.1f} s, exits "
                    f"{[rc for rc, _ in out]}\n")
    return out


def run_spec(spec, tmp, world, timeout):
    """Write ``spec`` and run it on ``world`` ranks; every rank must exit 0."""
    path = os.path.join(tmp, "spec.json")
    with open(path, "w") as f:
        json.dump(spec, f)
    res = launch([sys.executable, os.path.abspath(__file__), path], world, tmp, timeout)
    bad = [(r, rc) for r, (rc, _) in enumerate(res) if rc != 0]
    if bad:
        raise AssertionError(f"ranks (rank, exit) {bad}:\n" + "\n".join(
            f"--- rank {r} ---\n{log[-4000:]}" for r, (_, log) in enumerate(res)))
    return res


def save_tree(path, **trees):
    flat = {}

    def walk(prefix, node):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(f"{prefix}/{k}", v)
        else:
            flat[prefix.lstrip("/")] = np.asarray(node)

    for name, tree in trees.items():
        walk(name, tree)
    np.savez(path, **flat)


def load_tree(path, prefix=None):
    """A flat npz of ``a/b/c`` keys as nested dicts (the subtree under
    ``prefix`` when given)."""
    out = {}
    with np.load(path) as z:
        for key in z.files:
            parts = key.split("/")
            if prefix is not None:
                if parts[0] != prefix:
                    continue
                parts = parts[1:]
            node = out
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = z[key]
    return out


def params_hash(params) -> str:
    from sparknet_tpu_torch.parallel import comm

    h = hashlib.sha256()
    for x in comm.tree_leaves(params):
        h.update(x.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def _rows(batch, rank, world):
    per = len(next(iter(batch.values()))) // world
    return {k: v[rank * per:(rank + 1) * per] for k, v in batch.items()}


def _comm_config(job):
    from sparknet_tpu_torch.parallel import CommConfig

    return CommConfig(mode=job.get("comm", "auto"), compress=job.get("compress", "none"),
                      bucket_mb=job.get("bucket_mb", 4.0))


def run_solver(job, rank, world, out):
    from sparknet_tpu_torch.parallel import ParallelSolver
    from sparknet_tpu_torch.proto import caffe_pb

    os.environ.update(job.get("env", {}))
    with open(job["net"]) as f:
        net = caffe_pb.load_net(f.read(), is_path=False)
    batches = dict(np.load(job["batches"]))
    shapes = {k: v.shape[1:] for k, v in batches.items()}
    kw = {}
    if "test_batches" in job:
        tests = dict(np.load(job["test_batches"]))
        kw["test_input_shapes"] = {k: v.shape[1:] for k, v in tests.items()}
    s = ParallelSolver(caffe_pb.load_solver(job["solver"], is_path=False), shapes,
                       net_param=net, seed=3, device="cpu", mode=job["mode"],
                       tau=job.get("tau", 1), comm_config=_comm_config(job),
                       remat=job.get("remat", False), **kw)
    _train(job, s, batches, rank, world, out, tests if "test_batches" in job else None)


def run_bert(job, rank, world, out):
    import dataclasses

    from sparknet_tpu_torch.apps import bert_app
    from sparknet_tpu_torch.models.bert import BertConfig, BertMLM
    from sparknet_tpu_torch.parallel import ParallelSolver

    batches = dict(np.load(job["batches"]))
    shapes = {"input_ids": batches["input_ids"].shape[1:],
              "mlm_positions": batches["mlm_positions"].shape[1:]}
    cfg = dataclasses.replace(BertConfig.bert_tiny(vocab_size=job["vocab"]), **job["cfg"])
    sp = bert_app.make_solver_param(bert_app.make_args(lr=job["lr"], max_iter=100,
                                                       display=0, seed=0))
    s = ParallelSolver(sp, shapes, model=BertMLM(cfg, shapes, device="cpu"), seed=0,
                       device="cpu", mode=job["mode"], tau=job.get("tau", 1),
                       comm_config=_comm_config(job))
    _train(job, s, batches, rank, world, out)


def _train(job, s, batches, rank, world, out, tests=None):
    """Steps ``s`` from the job's weights or solverstate on this rank's
    rows, then tests and saves it as the job asks."""
    from sparknet_tpu_torch.nets import weights as W
    from sparknet_tpu_torch.parallel import comm, data_parallel, make_dp_train_step

    if not job.get("overlap", True):  # the same buckets started after the backward
        data_parallel._REDUCE_IN_BACKWARD = False
        try:
            step = make_dp_train_step(s._nets, s.sp, s.comm, s.group)
        finally:
            data_parallel._REDUCE_IN_BACKWARD = True
        s._train_step = (lambda p, st, o, b, it, _rng:
                         step(p, st, o, b, it, s._worker_generators(it)))
    if "restore" in job:
        s.restore(job["restore"])
    else:
        params, state = W.from_jax_params(load_tree(job["weights"], "params"),
                                          load_tree(job["weights"], "state"), s.train_net)
        s.params = params
        s.state = {**s.state, **state}
    res = {"taus": [], "in_backward": []}
    next_tau = s._next_tau

    def record_tau(*a):
        res["taus"].append(next_tau(*a))
        return res["taus"][-1]

    s._next_tau = record_tau
    finish = comm.BackwardReducer.finish

    def record_finish(reducer):
        res["in_backward"].append(len(reducer._started))
        res["buckets"] = len(reducer._plan)
        return finish(reducer)

    comm.BackwardReducer.finish = record_finish
    steps = job.get("steps", 0)
    feed = [_rows({k: v[i] for k, v in batches.items()}, rank, world)
            for i in range(len(next(iter(batches.values()))))]
    if "first" in job:  # the solver after its first step, in its own file
        s.step(iter(feed[:1]), 1)
        _save_solver(os.path.join(out, f"{job['first']}.r{rank}.npz"), s)
        feed, steps = feed[1:], steps - 1
    if steps:
        m = s.step(iter(feed), steps)
        res["loss"] = float(m[job.get("loss", "loss")])
    comm.BackwardReducer.finish = finish
    if tests is not None:
        n = len(next(iter(tests.values())))
        t = s.test(iter([_rows({k: v[i] for k, v in tests.items()}, rank, world)
                         for i in range(n)]), n)
        res["test"] = t
    if "save" in job:
        import torch

        s.save(job["save"])
        torch.distributed.barrier()  # written before a later job reads it
    _save_solver(os.path.join(out, f"{job['name']}.r{rank}.npz"), s,
                 **{k: v for k, v in res.items() if k != "test" or v})


def _save_solver(path, s, **res):
    from sparknet_tpu_torch.nets import weights as W

    save_tree(path, params=W.to_jax_params(s.params, s.train_net),
              state={l: {k: v.numpy() for k, v in e.items()} for l, e in s.state.items()},
              slots=W.to_jax_slots(s.opt_state, s.train_net),
              hash=params_hash(s.params), it=s.iter, **res)


def run_bn(job, rank, world, out):
    import torch
    import torch.distributed as dist

    from sparknet_tpu_torch.nets import layers as L
    from sparknet_tpu_torch.proto import caffe_pb

    net = caffe_pb.load_net(job["net"], is_path=False)
    bn, scale = (l for l in net.layers if l.type in ("BatchNorm", "Scale"))
    z = dict(np.load(job["inputs"]))
    x = torch.from_numpy(_rows({"x": z["x"]}, rank, world)["x"]).requires_grad_(True)
    dy = torch.from_numpy(_rows({"dy": z["dy"]}, rank, world)["dy"])
    p = {"weight": torch.from_numpy(z["gamma"]).requires_grad_(True),
         "bias": torch.from_numpy(z["beta"]).requires_grad_(True)}
    state = {"mean": torch.from_numpy(z["mean"]), "var": torch.from_numpy(z["var"])}
    ctx = L.ApplyCtx(train=True, group=dist.group.WORLD)
    (h,), new_state = L.BatchNorm.apply(bn, {}, [x], ctx, state)
    (y,) = L.Scale.apply(scale, p, [h], ctx)
    (y * dy).sum().backward()
    save_tree(os.path.join(out, f"{job['name']}.r{rank}.npz"), y=y.detach().numpy(),
              state={k: v.numpy() for k, v in new_state.items()}, dx=x.grad.numpy(),
              dgamma=p["weight"].grad.numpy(), dbeta=p["bias"].grad.numpy())


def run_stall(job, rank, world, out):
    from sparknet_tpu_torch.parallel import ParallelSolver
    from sparknet_tpu_torch.proto import caffe_pb

    s = ParallelSolver(caffe_pb.load_solver(job["solver"], is_path=False),
                       {"data": (8, 8), "label": (8,)},
                       net_param=caffe_pb.load_net(job["net"], is_path=False),
                       device="cpu", mode="sync")
    rng = np.random.default_rng(0)

    def feed():
        while True:
            yield {"data": rng.normal(size=(8 // world, 8)).astype(np.float32),
                   "label": rng.integers(0, 4, 8 // world).astype(np.int32)}

    s.step(feed(), 1)
    # the wall time of the step's end: rank 1 stops itself right after
    print(f"rank {rank}: stepped at {time.time():.3f}", flush=True)
    if rank == 1:
        os.kill(os.getpid(), signal.SIGSTOP)  # wedged: alive, silent, sockets open
    s.step(feed(), 1_000_000)
    print(f"rank {rank}: UNEXPECTEDLY completed", flush=True)


def run_resume(job, rank, world, out):
    from sparknet_tpu_torch.parallel import ParallelSolver
    from sparknet_tpu_torch.proto import caffe_pb
    from sparknet_tpu_torch.solver import snapshot

    res = {}
    try:
        res["path"] = snapshot.resolve_auto_resume(job["prefixes"][rank], None)
    except FileNotFoundError as e:
        res["error"] = str(e)
    if "path" in res:
        s = ParallelSolver(caffe_pb.load_solver(job["solver"], is_path=False),
                           {"data": (8, 8), "label": (8,)},
                           net_param=caffe_pb.load_net(job["net"], is_path=False),
                           device="cpu", mode="sync")
        s.restore(res["path"])
        res["iter"] = s.iter
    with open(os.path.join(out, f"{job['name']}.r{rank}.json"), "w") as f:
        json.dump(res, f)


JOBS = {"solver": run_solver, "bert": run_bert, "bn": run_bn, "stall": run_stall,
        "resume": run_resume}


def main():
    import torch

    torch.set_num_threads(1)
    with open(sys.argv[1]) as f:
        spec = json.load(f)
    sys.path.insert(0, REPO)
    from sparknet_tpu_torch.parallel import multihost

    assert multihost.initialize(device="cpu")
    rank, world = multihost.process_index(), multihost.process_count()
    for job in spec["jobs"]:
        JOBS[job["kind"]](job, rank, world, spec["out"])
    multihost.shutdown()
    print(f"rank {rank}: done", flush=True)


if __name__ == "__main__":
    main()

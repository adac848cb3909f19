#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``sparknet_tpu_torch``).

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with an NVIDIA Hopper
card, ``nvcc`` and PyTorch built for CUDA. Phases, each printed on its
own lines:

1. card: the device name and the ``nvidia-smi`` name / power-limit line;
2. build: every kernel of ``sparknet_tpu_torch/ops/csrc`` compiled from
   source (one ``nvcc`` per file, all started together), with timings
   and the compiler's register/shared-memory report;
3. kernels: each kernel held against its plain PyTorch version on the
   card (tolerances below), then timed with CUDA events at the shapes
   the serving path gives it, beside its memory/compute bound, the
   plain version and the one-call PyTorch equivalent;
4. serving: full-width ``bvlc_alexnet`` (random weights from seed 0)
   served on the card through InferenceEngine -> MicroBatcher -> HTTP
   InferenceServer; /healthz, /classify (1, 3, 8 rows), /metrics, then
   32- and 40-row calls through the batcher (40 rows exercise chunking).
   Every answer's top-5 is held against the same weights run by the port
   on the CPU, and the LRN kernel must have launched twice per bucket
   call;
5. profile: a bucket-32 forward split into upload, forward and download
   (CUDA events), then ``torch.profiler`` over bucket-32 forwards: device
   time by kernel, the LRN kernel's share, and the device's idle share;
6. load: 200 requests from 4 closed-loop clients through the batcher
   (the ``tools/serve --bench`` path): requests/s and latency.

Then one JSON line of per-kernel numbers ("ms", "plain_ms",
"library_ms" and "bound_ms" are per bucket-32 forward: norm1 + norm2)
and, last, the result line
``{"ok": true, "device": {...}}``. Any failed phase exits non-zero
without the result line, as does a machine without a CUDA card or a
directory without the port.

Tolerances. LRN kernel vs plain, f32: rtol 1e-5, atol 1e-6 (the two
sum the window in the same order; rsqrt/exp/log and fused multiply-adds
may differ in the last bits). bf16 output: within one bf16 ulp of the
plain result computed in f32 from the same bf16 inputs (the kernel
rounds an f32 result once). Serving top-5: the card's and the CPU's
indices must be equal, except that two classes whose CPU probabilities
differ by less than 1e-5 relative may trade places (f32 convolutions
sum in another order on the card; TF32 is switched off for both convs
and matmuls, so those differences stay near f32 rounding).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))

# NVIDIA H100 SXM published peaks (data sheet, dense, at the full 700 W)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12

# LRN shapes of bvlc_alexnet on the serving path, per row of the batch
ALEXNET_LRN = (("norm1", 55 * 55, 96), ("norm2", 27 * 27, 256))
LRN_GEOM = dict(size=5, alpha=1e-4, beta=0.75, k=1.0)


def log(msg: str = "") -> None:
    print(msg, flush=True)


class Phases:
    """Runs phases in order; a failure is printed and remembered, and
    the script exits non-zero at the end."""

    def __init__(self):
        self.failed = []

    def run(self, name, fn, *args):
        log(f"== phase {name}")
        t0 = time.perf_counter()
        try:
            out = fn(*args)
        except Exception:
            traceback.print_exc(file=sys.stdout)
            log(f"== phase {name}: FAILED after {time.perf_counter() - t0:.1f} s")
            self.failed.append(name)
            return None
        log(f"== phase {name}: ok in {time.perf_counter() - t0:.1f} s")
        return out


# ---------------------------------------------------------------- card
def phase_card():
    import torch

    name = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {name} "
        f"count {torch.cuda.device_count()}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    return name, smi


# --------------------------------------------------------------- build
def phase_build():
    from sparknet_tpu_torch.ops import _build

    t0 = time.perf_counter()
    built = _build.build_all()
    log(f"built {len(built)} kernel libraries in {time.perf_counter() - t0:.2f} s")
    for b in built.values():
        log(f"  {b.name}: {b.seconds:.2f} s -> {os.path.relpath(b.path, ROOT)}")
        for line in b.log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"    {line.strip()}")
    return built


# ------------------------------------------------------------- kernels
def _bf16_ulp(ref):
    import torch

    _, e = torch.frexp(ref)  # |ref| = m * 2^e, m in [0.5, 1)
    return torch.ldexp(torch.ones_like(ref), e - 8)


def _time_ms(fn, reps: int = 30, warm: int = 5) -> float:
    """Median of ``reps`` single launches, each between CUDA events."""
    import torch

    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def lrn_cases():
    """(label, m, c, size, alpha, beta, k, dtype name)."""
    cases = []
    for dt in ("float32", "bfloat16"):
        for name, hw, c in ALEXNET_LRN:
            cases.append((f"{name} B=32", 32 * hw, c, 5, 1e-4, 0.75, 1.0, dt))
        cases += [
            ("ragged M=1000", 1000, 96, 5, 0.5, 0.75, 2.0, dt),
            ("even size 4", 4096, 96, 4, 0.5, 0.75, 1.0, dt),
            ("C=1024", 2048, 1024, 5, 0.5, 0.75, 1.0, dt),
            ("C=1500 (two chunks)", 700, 1500, 7, 0.5, 0.75, 1.0, dt),
        ]
        for beta in (0.5, 1.0, 0.6):
            cases.append((f"beta={beta}", 3001, 256, 5, 0.5, beta, 1.0, dt))
    return cases


def phase_kernels():
    import torch
    import torch.nn.functional as F

    from sparknet_tpu_torch.ops.lrn import lrn_reference, lrn_rows

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    worst = {"float32": 0.0, "bfloat16": 0.0}
    failures = []
    for label, m, c, size, alpha, beta, k, dt in lrn_cases():
        dtype = getattr(torch, dt)
        x = (2.0 * torch.randn(m, c, generator=gen, device=dev)).to(dtype)
        y = lrn_rows(x, size, alpha, beta, k)
        torch.cuda.synchronize()
        if dtype == torch.float32:
            ref = lrn_reference(x, size, alpha, beta, k)
            err = (y - ref).abs()
            ok = bool(torch.all(err <= 1e-6 + 1e-5 * ref.abs()))
            tol = "rtol 1e-5 atol 1e-6"
        else:
            ref = lrn_reference(x.float(), size, alpha, beta, k)
            err = (y.float() - ref).abs()
            ok = bool(torch.all(err <= _bf16_ulp(ref)))
            tol = "1 bf16 ulp"
        e = float(err.max())
        worst[dt] = max(worst[dt], e)
        log(f"  lrn {label:<22} {dt:<8} ({m}, {c}) size={size} beta={beta}: "
            f"max_abs_err {e:.3e} [{tol}] {'ok' if ok else 'MISMATCH'}")
        if not ok:
            failures.append(f"{label} {dt}")
    if failures:
        raise AssertionError(f"LRN kernel disagrees with lrn_reference: {failures}")

    # time at the serving path's shapes (bucket 32), f32
    timing = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0,
              "bytes_ms": 0.0, "ops_ms": 0.0}
    for name, hw, c in ALEXNET_LRN:
        n = 32
        m = n * hw
        x = torch.relu(torch.randn(m, c, generator=gen, device=dev))
        g = LRN_GEOM
        h = int(round(hw ** 0.5))
        x_nchw = x.view(n, h, h, c).permute(0, 3, 1, 2)  # channels_last view
        ms = _time_ms(lambda: lrn_rows(x, g["size"], g["alpha"], g["beta"], g["k"]))
        plain = _time_ms(lambda: lrn_reference(x, g["size"], g["alpha"], g["beta"], g["k"]))
        lib = _time_ms(lambda: F.local_response_norm(
            x_nchw, g["size"], g["alpha"], g["beta"], g["k"]))
        nbytes = 2 * m * c * x.element_size()  # read x once, write y once
        ops = m * c * (2 * g["size"] + 6)  # window multiply-adds, d, power, scale
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / F32_FLOPS_PER_S * 1e3
        bound = max(bytes_ms, ops_ms)
        log(f"  time {name} B=32 ({m}, {c}) f32: kernel {ms:.4f} ms, plain "
            f"{plain:.4f} ms, F.local_response_norm {lib:.4f} ms, bound "
            f"{bound:.4f} ms ({'bytes' if bytes_ms >= ops_ms else 'operations'}: "
            f"{nbytes / 1e6:.1f} MB, {ops / 1e6:.1f} Mop), "
            f"{nbytes / (ms * 1e-3) / 1e9:.0f} GB/s = "
            f"{100 * bound / ms:.1f}% of bound")
        for key, v in (("ms", ms), ("plain_ms", plain), ("library_ms", lib),
                       ("bound_ms", bound), ("bytes_ms", bytes_ms),
                       ("ops_ms", ops_ms)):
            timing[key] += v
    # the serving path runs f32; bf16 errors are bounded per element above
    timing["max_abs_err"] = worst["float32"]
    log(f"  worst |kernel - plain|: f32 {worst['float32']:.3e}, "
        f"bf16 {worst['bfloat16']:.3e} (each within its tolerance)")
    timing["bound_by"] = "bytes" if timing["bytes_ms"] >= timing["ops_ms"] else "operations"
    return timing


# ------------------------------------------------------------- serving
def _check_topk(label, idx_gpu, idx_cpu, probs_cpu_full):
    """Top-5 equal, except near-ties on the CPU side (module docstring)."""
    import numpy as np

    idx_gpu = np.asarray(idx_gpu)
    for r in range(len(idx_cpu)):
        if np.array_equal(idx_gpu[r], idx_cpu[r]):
            continue
        p = probs_cpu_full[r]
        want = p[idx_cpu[r]]
        got = p[idx_gpu[r]]
        if not np.allclose(got, want, rtol=1e-5, atol=0):
            raise AssertionError(
                f"{label} row {r}: top-5 {idx_gpu[r].tolist()} on the card vs "
                f"{idx_cpu[r].tolist()} on the CPU (CPU probs {got} vs {want})"
            )
        log(f"  {label} row {r}: near-tie reorder within 1e-5, accepted")


def phase_serving():
    import numpy as np
    import torch

    from sparknet_tpu_torch.models import ALEXNET_DEPLOY
    from sparknet_tpu_torch.ops.lrn import lrn_rows
    from sparknet_tpu_torch.serve.engine import InferenceEngine
    from sparknet_tpu_torch.serve.metrics import ServeMetrics
    from sparknet_tpu_torch.serve.server import InferenceServer

    buckets = (1, 8, 32)
    metrics = ServeMetrics(buckets)
    t0 = time.perf_counter()
    eng = InferenceEngine.from_files(ALEXNET_DEPLOY, device="cuda",
                                     buckets=buckets, metrics=metrics)
    ref = InferenceEngine.from_files(ALEXNET_DEPLOY, device="cpu", buckets=buckets)
    n_params = sum(t.numel() for e in eng.params.values() for t in e.values())
    log(f"  bvlc_alexnet: {n_params} parameters, built in "
        f"{time.perf_counter() - t0:.1f} s")
    for layer, e in eng.params.items():
        for pname, t in e.items():
            if not torch.equal(t.cpu(), ref.params[layer][pname]):
                raise AssertionError(f"{layer}.{pname}: card and CPU weights differ")
    eng.warmup()
    log(f"  warmup of buckets {buckets}: {eng.warmup_s} s")

    rng = np.random.default_rng(0)
    row_shape = eng._row_shapes["data"]

    def rows(n):
        # 3 decimals keep the JSON bodies small; the CPU sees the same rows
        return np.round(rng.normal(size=(n,) + row_shape), 3).astype(np.float32)

    server = InferenceServer(eng, metrics=metrics, port=0,
                             model_name="bvlc_alexnet_deploy.prototxt")
    if not server.batcher.wait_ready(300):  # its worker warms the buckets
        raise AssertionError("batcher worker did not finish its warmup")
    answers = []  # (label, rows, top-5 indices from the card)
    lrn_rows.launches = 0  # count the main path only
    server.start()
    try:
        client = server.client(timeout=300)
        code, health = client.healthz()
        if code != 200 or health["status"] != "ok":
            raise AssertionError(f"/healthz: {code} {health}")
        log(f"  /healthz {code}: device {health['device']}, buckets "
            f"{health['buckets']}, gen {health['generation']}")
        for n in (1, 3, 8):
            x = rows(n)
            t1 = time.perf_counter()
            code, body = client.classify(x, top_k=5)
            if code != 200:
                raise AssertionError(f"/classify {n} rows: {code} {body}")
            log(f"  /classify {n} rows: {code} in {time.perf_counter() - t1:.2f} s "
                f"(JSON included), gen {body['gen']}")
            answers.append((f"/classify {n} rows", x, body["indices"]))
        code, text = client.prometheus()
        if code != 200 or "sparknet_serve_requests_total 3" not in text:
            raise AssertionError(f"/metrics: {code} {text[:200]!r}")
        code, snap = client.metrics()
        if code != 200 or snap["requests"] != 3 or snap["errors"] != 0:
            raise AssertionError(f"/metrics.json: {code} {snap}")
        log(f"  /metrics {code}: {snap['requests']} requests, {snap['errors']} errors")
        for n in (32, 40):
            x = rows(n)
            out = server.batcher.submit(x, block=True).result(timeout=300)
            if out.shape != (n, 1000) or not np.all(np.isfinite(out)):
                raise AssertionError(f"batcher {n} rows: output {out.shape}")
            if not np.allclose(out.sum(-1), 1.0, atol=1e-4):
                raise AssertionError(f"batcher {n} rows: probabilities do not sum to 1")
            idx, _ = eng.postprocess(out, 5)
            answers.append((f"batcher {n} rows", x, idx))
    finally:
        server.stop()
    launches = lrn_rows.launches
    snap = metrics.snapshot()
    calls = sum(e["batches"] for e in snap["per_bucket"].values())
    log(f"  LRN kernel launches on the serving path: {launches} over {calls} "
        f"bucket calls ({snap['per_bucket']['1']['batches']} x b1, "
        f"{snap['per_bucket']['8']['batches']} x b8, "
        f"{snap['per_bucket']['32']['batches']} x b32)")
    if calls != 6 or launches != 2 * calls:
        raise AssertionError(f"want 2 LRN launches per bucket call over 6 calls, "
                             f"got {launches} over {calls}")
    for b, e in snap["per_bucket"].items():
        log(f"  metrics bucket {b}: device_latency {e['device_latency']}, "
            f"padding_waste {e['padding_waste']}")

    # every answer against the CPU run of the same weights
    for label, x, idx in answers:
        probs = ref.infer(x)
        idx_cpu, _ = ref.postprocess(probs, 5)
        _check_topk(label, idx, idx_cpu, probs)
        log(f"  {label}: top-5 equal to the CPU run")

    # no relayout: the LRN bottoms are contiguous NHWC straight off the convs
    params, state, _ = eng._weights_snapshot()
    x = torch.from_numpy(rows(1)).cuda()
    blobs, _ = eng.net.apply(params, state, {"data": x}, train=False)
    for blob in ("conv1", "conv2"):
        if not blobs[blob].is_contiguous():
            raise AssertionError(f"{blob} is not contiguous NHWC: LRN would copy it")
    log("  conv1/conv2 come out contiguous NHWC: the LRN row view is free")

    # steady-state latency per bucket, engine.infer (host clock, synchronised)
    latency = {}
    for b in buckets:
        x = rows(b)
        times = []
        for _ in range(12):
            t1 = time.perf_counter()
            eng.infer(x)
            times.append((time.perf_counter() - t1) * 1e3)
        latency[b] = statistics.median(times[2:])
        log(f"  engine.infer bucket {b}: median {latency[b]:.3f} ms over 10 calls "
            f"(host clock, upload + forward + download)")
    return {"launches": launches, "latency_ms": latency, "engine": eng,
            "rows": rows}


def phase_profile(serving):
    """Where the device time of one bucket-32 forward goes, by kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    eng, reps = serving["engine"], 5
    x = serving["rows"](32)
    eng.infer(x)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            eng.infer(x)  # ends in a copy to the host: synchronised
        wall = (time.perf_counter() - t0) / reps * 1e6  # us per forward
    kernels = [
        e for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA
    ]

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(
            e, "self_cuda_time_total", 0.0)

    # the same forward split in three without the profiler, CUDA events:
    # upload of the host batch, the net on the card, download of the output
    params, state, _ = eng._weights_snapshot()
    host = torch.from_numpy(x)
    pinned = host.pin_memory()
    xd = host.to("cuda")
    up = _time_ms(lambda: host.to("cuda"), reps=20)
    up_pinned = _time_ms(lambda: pinned.to("cuda", non_blocking=True), reps=20)
    fwd = _time_ms(lambda: eng.net.apply(params, state, {"data": xd}, train=False),
                   reps=20)
    out = eng.net.apply(params, state, {"data": xd}, train=False)[0][eng.output]
    down = _time_ms(lambda: out.cpu(), reps=20)
    log(f"  bucket 32 without the profiler (CUDA events, median of 20): upload "
        f"{up:.3f} ms pageable ({host.numel() * 4 / 1e6:.1f} MB; {up_pinned:.3f} ms "
        f"from pinned memory), forward {fwd:.3f} ms, download {down:.3f} ms")

    total = sum(dev_us(e) for e in kernels) / reps
    if not total:
        log("  device time by kernel: not measured (the profiler saw no device events)")
        return None
    lrn = sum(dev_us(e) for e in kernels if "lrn_fwd" in e.key) / reps
    log(f"  bucket 32: device busy {total / 1e3:.3f} ms per forward of "
        f"{wall / 1e3:.3f} ms wall under the profiler (idle share "
        f"{100 * (1 - total / wall):.1f}%); LRN kernel {lrn / 1e3:.4f} ms = "
        f"{100 * lrn / total:.1f}% of device time")
    for e in sorted(kernels, key=dev_us, reverse=True)[:10]:
        log(f"    {dev_us(e) / reps / 1e3:8.4f} ms  {e.count // reps:3d}x  {e.key[:90]}")
    return total


def phase_load(serving):
    """Closed-loop load through the batcher (tools/serve --bench's path)."""
    from sparknet_tpu_torch.serve.loadgen import run_loadgen
    from sparknet_tpu_torch.serve.metrics import ServeMetrics

    eng = serving["engine"]
    eng.metrics = ServeMetrics(eng.buckets)
    rec = run_loadgen(eng, n_requests=200, sizes=(1, 2, 5, 8, 3), concurrency=4,
                      metrics=eng.metrics)
    if rec["errors"]:
        raise AssertionError(f"load generator errors: {rec['error_samples']}")
    log(f"  closed loop, 4 clients, sizes 1/2/5/8/3: {rec['value']} requests/s, "
        f"{rec['rows_per_sec']} rows/s, p50 {rec['p50_ms']} ms, p99 "
        f"{rec['p99_ms']} ms (log bins), {rec['requests']} requests, 0 errors")
    for b, e in rec["metrics"]["per_bucket"].items():
        log(f"    bucket {b}: {e['batches']} calls, padding_waste "
            f"{e['padding_waste']}, device p50 {e['device_latency']['p50_ms']} ms")
    return rec


# ---------------------------------------------------------------- main
def main(argv=None) -> int:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(argv)
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "sparknet_tpu_torch")):
        print(f"chip_smoke: no sparknet_tpu_torch package beside {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    # f32 means f32 on the card too: no TF32 in convolutions or matmuls
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    phases = Phases()
    card = phases.run("card", phase_card)
    built = phases.run("build", phase_build)
    timing = phases.run("kernels", phase_kernels) if built else None
    serving = None
    if built:
        serving = phases.run("serving", phase_serving)
        if serving:
            phases.run("profile", phase_profile, serving)
            phases.run("load", phase_load, serving)
    if phases.failed:
        log(f"chip_smoke: FAILED phases: {phases.failed}")
        return 1
    log(json.dumps({"kernels": [{
        "name": "lrn_fwd",
        "route": "cuda",
        "source": "sparknet_tpu_torch/ops/csrc/lrn.cu",
        "replaces": "sparknet_tpu/ops/lrn.py:85",
        "launches": serving["launches"],
        "max_abs_err": timing["max_abs_err"],
        "ms": timing["ms"],
        "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"],
        "bound_by": timing["bound_by"],
        "library_ms": timing["library_ms"],
    }]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card[0], "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

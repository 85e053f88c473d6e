"""Profiling and benchmarking harness.

The reference's observability is a pytest-benchmark suite
(test/test_benchmarks.py) plus cProfile scripts; here the same benchmark
groups (quantize/decision, BPS, equaliser training per method, soft LLR,
apply_filter, select_angles) are reproduced as timed jitted kernels reporting
Msym/s of the device they run on, plus a jax.profiler trace context for
device timeline capture.

Run: python -m qampy_tpu.profiling
"""
from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import jax
import jax.numpy as jnp


#: default trace directory: chiprun_out/trace in the checkout
TRACE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "chiprun_out", "trace")


@contextlib.contextmanager
def trace(logdir=TRACE_DIR):
    """Capture a jax.profiler trace (view with tensorboard/xprof)."""
    jax.profiler.start_trace(logdir)
    try:
        yield logdir
    finally:
        jax.profiler.stop_trace()


def time_fn(fn, *args, reps=5, warmup=1):
    """Median wall time of a jitted function (compile excluded)."""
    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn(*args)
        jax.block_until_ready(out)
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def run_benchmarks(nsyms=2 ** 18, M=64, reps=5, methods=("cma", "mcma", "rde", "sbd", "mddma", "dd")):
    """Reproduce the reference benchmark groups (test/test_benchmarks.py:23-176).

    Returns {name: Msym/s}.
    """
    from qampy_tpu.ops import equaliser as eqops
    from qampy_tpu.ops import phase as phops
    from qampy_tpu.core import metrics
    from qampy_tpu.theory import cal_symbols_qam, cal_scaling_factor_qam

    rng = np.random.default_rng(0)
    results = {}
    const = (cal_symbols_qam(M) / np.sqrt(cal_scaling_factor_qam(M))).astype(np.complex64)
    z = (rng.standard_normal(nsyms) + 1j * rng.standard_normal(nsyms)).astype(np.complex64) * 0.7
    zd = jax.device_put(z)
    constd = jax.device_put(const)

    # quantize/decision (reference :23-30 uses 128-QAM 2^20; scaled per nsyms)
    dec = jax.jit(lambda e: metrics.decision_idx(e, constd))
    results["decision"] = nsyms / time_fn(dec, zd, reps=reps) / 1e6

    # BPS 64 angles (reference :38-47)
    angles = jnp.linspace(-np.pi / 4, np.pi / 4, 64, endpoint=False,
                          dtype=np.float32).reshape(1, -1)
    grid = phops.detect_grid(const)
    bps = jax.jit(lambda e: phops.bps_idx(e, angles, constd, 14, grid=grid))
    results["bps"] = nsyms / time_fn(bps, zd, reps=reps) / 1e6

    # equaliser training per method (reference :49-77: QPSK 1e5, 40 taps, os=2)
    E2 = (rng.standard_normal((2, 2 * nsyms // 4)) +
          1j * rng.standard_normal((2, 2 * nsyms // 4))).astype(np.complex64)
    E2d = jax.device_put(E2)
    trs = (E2.shape[-1] - 40) // 2
    w0 = jnp.asarray(eqops._init_taps(40, 2, 2, np.complex64))
    for method in methods:
        syms = jnp.asarray(eqops._reshape_symbols(None, method, M, np.complex64, 2))
        tr = jax.jit(lambda e, s=syms, m=method: eqops.train_equaliser_block(
            e, trs, 1, 2, 1e-3, w0, s, m, adaptive=True, block_size=64))
        results["train_" + method] = trs * 2 / time_fn(tr, E2d, reps=reps) / 1e6

    # apply_filter (reference :128-151)
    wx = jnp.asarray(eqops._init_taps(17, 2, 2, np.complex64))
    ap = jax.jit(lambda e: eqops.apply_filter_to_signal(e, 2, wx))
    results["apply_filter"] = (E2.shape[-1] // 2) * 2 / time_fn(ap, E2d, reps=reps) / 1e6

    # soft LLR demapper (reference :112-126)
    s_obj_bitmap = _bitmap(M)
    llr = jax.jit(lambda e: metrics.soft_l_value_demapper(e, 100., s_obj_bitmap))
    results["soft_llr"] = nsyms / time_fn(llr, zd, reps=reps) / 1e6

    # select_angles gather (reference :153-176)
    idx = jax.device_put(rng.integers(0, 64, nsyms).astype(np.int32))
    ang2 = jnp.tile(angles, (nsyms, 1))
    sel = jax.jit(lambda a, i: phops.select_angles(a, i))
    results["select_angles"] = nsyms / time_fn(sel, ang2, idx, reps=reps) / 1e6
    return results


def _bitmap(M):
    from qampy_tpu.signals import SignalQAMGrayCoded
    import numpy as np
    s = SignalQAMGrayCoded(M, 64, seed=0)
    return s.bitmap_mtx


if __name__ == "__main__":
    import json
    from qampy_tpu import compile_cache
    compile_cache.enable()
    print("device: %s x%d" % (jax.devices()[0].device_kind,
                              len(jax.devices())))
    res = run_benchmarks()
    print(json.dumps({k: round(v, 2) for k, v in res.items()}, indent=1))

"""Measure the reference implementation's runnable backends on this host CPU.

BASELINE.md's consequence line: "reference-side wall-clock numbers must be
generated by us". The reference's production backend is pythran-compiled
C++ (setup.py:57-74), but pythran is not installed in this image, so the
pythran modules run as interpreted Python (they are valid Python with
`#pythran export` annotations). What IS representative of the reference on
this host:

- `bps(method="py")` (core/phaserecovery.py:81-91): the reference's own
  vectorised-numpy BPS backend — full-speed numpy, a fair CPU number.
- `apply_filter_to_signal` / `train_equaliser` interpreted: a LOWER BOUND
  for the reference (compiled pythran is typically 10-100x faster on such
  loops); reported with that caveat.
- qampy_tpu's own chain run on the SAME host CPU via the JAX CPU backend:
  apples-to-apples same-silicon comparison.

Usage: python tools/refbench.py   (takes ~2-4 min, CPU only)
Prints one JSON line per measurement and a summary table.
"""
import json
import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "")  # decided below

import numpy as np

sys.path.insert(0, "/root/reference")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

RESULTS = []


def timeit(fn, *args, reps=3, **kwargs):
    fn(*args, **kwargs)  # warm
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn(*args, **kwargs)
        best = min(best, time.perf_counter() - t0)
    return best


def record(name, nsym, seconds, note):
    msym_s = nsym / seconds / 1e6
    row = {"bench": name, "nsym": nsym, "seconds": round(seconds, 4),
           "Msym/s": round(msym_s, 3), "note": note}
    RESULTS.append(row)
    print(json.dumps(row), flush=True)


def ref_bps_py():
    """Reference's vectorised numpy BPS backend (phaserecovery.py:81-91)."""
    from qampy import signals
    from qampy.core import phaserecovery as cphase
    L = 2 ** 15
    sig = signals.SignalQAMGrayCoded(64, L, nmodes=2, fb=25e9)
    E = np.asarray(sig).astype(np.complex64)
    t = timeit(cphase.bps, E, 64, sig.coded_symbols.astype(np.complex64), 14,
               method="py", reps=2)
    record("ref bps py (64QAM, 64 angles, dual-pol)", 2 * L, t,
           "reference's own vectorised numpy backend, full speed")


def ref_train_interpreted():
    """Reference equaliser training loop, interpreted pythran fallback."""
    from qampy import signals, impairments
    from qampy.core.equalisation import equalisation as cequalisation
    L = 2 ** 12
    sig = signals.SignalQAMGrayCoded(64, L, nmodes=2, fb=25e9)
    s2 = sig.resample(50e9, beta=0.1)
    s2 = impairments.change_snr(s2, 30)
    E = np.asarray(s2).astype(np.complex128)
    t = timeit(cequalisation.equalise_signal, E, 2, 1e-3, 64, Ntaps=19,
               method="mcma", adaptive_stepsize=True, reps=1)
    record("ref train_equaliser interpreted (MCMA, 19 taps)", 2 * L, t,
           "LOWER BOUND: pythran not installed, loop runs interpreted; "
           "compiled C++ typically 10-100x faster")


def ref_apply_filter_interpreted():
    from qampy.core.equalisation import pythran_equalisation as peq
    L = 2 ** 13
    E = (np.random.randn(2, 2 * L) + 1j * np.random.randn(2, 2 * L)).astype(np.complex128)
    wxy = (np.random.randn(2, 2, 19) + 1j * np.random.randn(2, 2, 19)).astype(np.complex128)
    t = timeit(peq.apply_filter_to_signal, E, 2, wxy, reps=1)
    record("ref apply_filter interpreted (19 taps, os=2)", 2 * L, t,
           "LOWER BOUND: interpreted pythran fallback")


def ours_chain_cpu():
    """Our flagship chain on the same host CPU (JAX CPU backend)."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import qampy_tpu as qt
    from qampy_tpu import impairments as qimp
    from qampy_tpu.ops import chain as qchain
    import jax.random as jr

    L = 2 ** 18
    sig = qt.SignalQAMGrayCoded(64, L, nmodes=2, fb=25e9, seed=7)
    up = sig.resample(50e9, beta=0.1)
    up = qimp.change_snr(up, 35, key=jr.PRNGKey(7))
    rx = qchain.make_rx_chain(64, Ntaps=19, TrSyms=2 ** 14,
                              methods=("mcma", "mddma"),
                              bps_angles=64, bps_N=14)
    samples = jnp.asarray(np.asarray(up.samples))

    def run(x):
        out = rx(x)
        return out[0] if isinstance(out, tuple) else out

    jitted = jax.jit(run)
    jitted(samples).block_until_ready()  # warm/compile
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        jitted(samples).block_until_ready()
        best = min(best, time.perf_counter() - t0)
    record("qampy_tpu full chain on host CPU (XLA)", 2 * L, best,
           "same silicon as reference rows")


def main():
    np.random.seed(0)
    print("# refbench: reference backends on host CPU", flush=True)
    ref_bps_py()
    ref_apply_filter_interpreted()
    ref_train_interpreted()
    ours_chain_cpu()
    print("\n| bench | Msym/s | note |")
    print("|---|---|---|")
    for r in RESULTS:
        print(f"| {r['bench']} | {r['Msym/s']} | {r['note']} |")


if __name__ == "__main__":
    main()

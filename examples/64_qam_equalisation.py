"""Two-stage MCMA->MRDE equalisation of dual-pol 64-QAM.

Workload parity: reference Scripts/64_qam_equalisation.py
(BASELINE.md). Run: python examples/64_qam_equalisation.py
"""
import sys as _sys, pathlib as _pl
_sys.path.insert(0, str(_pl.Path(__file__).resolve().parents[1]))  # repo root
import time
import numpy as np
import jax.random as jr
import qampy_tpu as qt
from qampy_tpu import equalisation, impairments, helpers

fb = 40e9
M = 64
sig = qt.SignalQAMGrayCoded(M, 2 ** 18, nmodes=2, fb=fb, seed=2)
sig = sig.resample(2 * fb, beta=0.1)
sig = impairments.change_snr(sig, 30, key=jr.PRNGKey(1))
sig = impairments.apply_PMD(sig, np.pi / 5.6, 75e-12)

t0 = time.time()
E, wxy, (err1, err2) = equalisation.dual_mode_equalisation(
    sig, (1e-3, 1e-3), 33, methods=("mcma", "mrde"),
    adaptive_stepsize=(True, True), backend="block")
print("equalisation took %.2fs" % (time.time() - t0))
E = E.replace(samples=helpers.normalise_and_center(E.samples))
print("SER:", np.asarray(E.cal_ser()))
gmi, _ = E.cal_gmi()
print("GMI:", gmi)

"""Dual-pol 32-QAM (cross constellation) two-stage equalisation.

Workload parity: reference Scripts/32_qam_equalisation.py (same channel:
25 dB SNR, PMD theta=pi/4.6 with 20 ps DGD, MCMA -> SBD, 11 taps).
Run: python examples/32_qam_equalisation.py
"""
import sys as _sys, pathlib as _pl
_sys.path.insert(0, str(_pl.Path(__file__).resolve().parents[1]))  # repo root
import numpy as np
import jax.random as jr
import qampy_tpu as qt
from qampy_tpu import equalisation, impairments, helpers

fb = 40e9
sig = qt.SignalQAMGrayCoded(32, 2 ** 18, nmodes=2, fb=fb, seed=11)
sig = sig.resample(2 * fb, beta=0.1, renormalise=True)
sig = impairments.change_snr(sig, 25, key=jr.PRNGKey(1))
sig = impairments.apply_PMD(sig, np.pi / 4.6, 20e-12)

E, wxy, (err, err2) = equalisation.dual_mode_equalisation(
    sig, (1e-3, 1e-3), 11, methods=("mcma", "sbd"), adaptive_stepsize=(True, True))
E = E.replace(samples=helpers.normalise_and_center(E.samples))
print("EVM (%):", 100 * np.asarray(E.cal_evm()))
print("SER:", np.asarray(E.cal_ser()))
print("GMI:", np.asarray(E.cal_gmi()[0]))

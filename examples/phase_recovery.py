"""Blind phase search carrier recovery under laser phase noise.

Workload parity: reference Scripts/phaserecoverytest.py
(BASELINE.md). Run: python examples/phase_recovery.py
"""
import sys as _sys, pathlib as _pl
_sys.path.insert(0, str(_pl.Path(__file__).resolve().parents[1]))  # repo root
import numpy as np
import jax.random as jr
import qampy_tpu as qt
from qampy_tpu import phaserec, impairments, helpers

fb = 40e9
M = 64
sig = qt.SignalQAMGrayCoded(M, 2 ** 17, fb=fb, seed=3)
sig = impairments.change_snr(sig, 30, key=jr.PRNGKey(2))
sig = impairments.apply_phase_noise(sig, 100e3, key=jr.PRNGKey(3))

rec, phase = phaserec.bps_twostage(sig, 32, 14, B=8)
rec = rec.replace(samples=helpers.dump_edges(rec.samples, 20))
print("SER after two-stage BPS:", np.asarray(rec.cal_ser()))

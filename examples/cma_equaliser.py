"""Single-stage CMA equalisation of a rotated dual-pol QPSK signal.

Workload parity: reference Scripts/cma_equaliser.py.
Run: python examples/cma_equaliser.py
"""
import sys as _sys, pathlib as _pl
_sys.path.insert(0, str(_pl.Path(__file__).resolve().parents[1]))  # repo root
import numpy as np
import jax.random as jr
import qampy_tpu as qt
from qampy_tpu import equalisation, impairments, helpers

fb = 40e9
sig = qt.SignalQAMGrayCoded(4, 2 ** 16, nmodes=2, fb=fb, seed=1)
sig = sig.resample(2 * fb, beta=0.1)
sig = impairments.change_snr(sig, 14, key=jr.PRNGKey(0))
sig = impairments.apply_PMD(sig, np.pi / 5.65, 100e-12)

E, wxy, err = equalisation.equalise_signal(sig, 1e-3, Ntaps=17, method="cma",
                                           adaptive_stepsize=True, apply=True)
E = E.replace(samples=helpers.normalise_and_center(E.samples))
print("SER:", np.asarray(E.cal_ser()))
print("EVM (dB):", 20 * np.log10(np.asarray(E.cal_evm())))

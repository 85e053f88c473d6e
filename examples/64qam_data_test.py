"""Recover measured 64-QAM symbols loaded from a matlab file.

Workload parity: reference Scripts/64qam_data_test.py — loads the bundled
20-GBaud SRRC-0.05 64-QAM PRBS15 symbol set, builds a fake-polmux dual-pol
signal, passes it through a synthetic channel, and recovers it with the
MCMA->SBD dual-mode equaliser.
Run: python examples/64qam_data_test.py [path/to/file.mat]
"""
import sys as _sys, pathlib as _pl
_sys.path.insert(0, str(_pl.Path(__file__).resolve().parents[1]))  # repo root
import os
import sys
import numpy as np
import jax.random as jr
from qampy_tpu import io as qio
from qampy_tpu import equalisation, impairments, helpers

MAT = sys.argv[1] if len(sys.argv) > 1 else \
    "/root/reference/Scripts/data/20GBaud_SRRC0P05_64QAM_PRBS15.mat"
if not os.path.exists(MAT):
    sys.exit("matlab data file not found: %s" % MAT)

symbs = qio.load_symbols_from_matlab_file(MAT, 64, (("X_Symbs",),), fb=20e9,
                                          normalise=True, fake_polmux=True)
print("loaded symbols:", symbs.shape, "fb=%.0f GBd" % (symbs.fb / 1e9))
sig = symbs.resample(2 * symbs.fb, beta=0.05)
sig = impairments.change_snr(sig, 30, key=jr.PRNGKey(0))
sig = impairments.apply_PMD(sig, np.pi / 5.6, 30e-12)

E, wxy, err = equalisation.dual_mode_equalisation(
    sig, (6e-4, 6e-4), 17, methods=("mcma", "sbd"), adaptive_stepsize=(True, True))
E = E.replace(samples=helpers.normalise_and_center(E.samples))
gmi, _ = E.cal_gmi()
print("GMI:", np.asarray(gmi))
print("SER:", np.asarray(E.cal_ser()))

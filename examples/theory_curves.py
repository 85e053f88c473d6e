"""Analytic BER/SER/GMI curves vs SNR (reference Scripts/ber_vs_evm*.py)."""
import sys as _sys, pathlib as _pl
_sys.path.insert(0, str(_pl.Path(__file__).resolve().parents[1]))  # repo root
import numpy as np
from qampy_tpu import theory

snr_db = np.arange(5, 30, 2)
snr = 10 ** (snr_db / 10)
for M in (4, 16, 64):
    ser = np.asarray(theory.ser_vs_es_over_n0_qam(snr, M))
    ber = np.asarray(theory.ber_vs_es_over_n0_qam(snr, M))
    print("M=%d" % M)
    for s, a, b in zip(snr_db, ser, ber):
        print("  %2d dB  SER %.3e  BER %.3e" % (s, a, b))
gmi = theory.cal_gmi(16, np.array([10., 15., 20.]), N=500)
print("16-QAM GMI @10/15/20 dB:", gmi)

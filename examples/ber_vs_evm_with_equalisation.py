"""BER/SER/EVM vs SNR measured AFTER blind equalisation, against theory.

Workload parity: reference Scripts/ber_vs_evm_with_equalisation.py —
sweep SNR for several QAM orders, equalise the oversampled signal with
adaptive MCMA (13 taps), and compare counted BER/SER and both blind and
data-aided EVM against the analytic curves (Shafik 2006 EVM<->BER
relations, theory.ber_vs_evm_qam). Run:
python examples/ber_vs_evm_with_equalisation.py
"""
import sys as _sys, pathlib as _pl
_sys.path.insert(0, str(_pl.Path(__file__).resolve().parents[1]))  # repo root
import numpy as np
import jax.random as jr
import qampy_tpu as qt
from qampy_tpu import equalisation, impairments, helpers, theory

fb, os_, ntaps, beta = 10e9, 2, 13, 0.1
N = 2 ** 16
snrs_db = np.linspace(5, 30, 8)

for M in (4, 16):
    print("%d-QAM   (theory BER in parentheses)" % M)
    print("SNR(dB)    SER        BER(counted)   EVM blind(dB)  EVM known(dB)")
    for sr in snrs_db:
        sig = qt.SignalQAMGrayCoded(M, N, nmodes=1, fb=fb, seed=int(sr) + M)
        sig = sig.resample(fnew=os_ * fb, beta=beta, renormalise=True)
        sig_s = impairments.change_snr(sig, sr, key=jr.PRNGKey(int(sr)))
        wx, er = equalisation.equalise_signal(sig_s, 3e-4, Ntaps=ntaps,
                                              method="mcma",
                                              adaptive_stepsize=True)
        after = equalisation.apply_filter(sig_s, wx)
        after = after.replace(samples=helpers.normalise_and_center(after.samples))
        evm_blind = float(np.asarray(after.cal_evm())[0])
        evm_known = float(np.asarray(after.cal_evm(blind=False))[0])
        ser = float(np.asarray(after.cal_ser())[0])
        ber = float(np.asarray(after.cal_ber())[0])
        ber_th = float(np.asarray(
            theory.ber_vs_es_over_n0_qam(10 ** (sr / 10), M)))
        print("  %4.1f   %.3e   %.3e (%.1e)   %6.1f        %6.1f"
              % (sr, ser, ber, ber_th,
                 float(helpers.lin2dB(evm_blind ** 2)),
                 float(helpers.lin2dB(evm_known ** 2))))

"""BER measured by counting vs BER estimated from EVM, across SNR.

Workload parity: reference Scripts/ber_vs_evm.py — demonstrates that the
EVM-based analytic BER estimate (theory.ber_vs_evm_qam) tracks the counted
BER through an AWGN channel. Run: python examples/ber_vs_evm.py
"""
import sys as _sys, pathlib as _pl
_sys.path.insert(0, str(_pl.Path(__file__).resolve().parents[1]))  # repo root
import numpy as np
import jax.random as jr
import qampy_tpu as qt
from qampy_tpu import impairments, theory

M = 16
snrs_db = np.arange(5, 18, 2)
sig = qt.SignalQAMGrayCoded(M, 2 ** 16, nmodes=1, seed=7)
print("SNR(dB)  BER(counted)  BER(from EVM)  BER(theory)")
for i, snr in enumerate(snrs_db):
    n = impairments.change_snr(sig, snr, key=jr.PRNGKey(int(snr)))
    ber = float(np.asarray(n.cal_ber(synced=True))[0])
    evm = float(np.asarray(n.cal_evm(synced=True, blind=False))[0])
    # ber_vs_evm_qam expects the EVM as a power ratio in dB (reference theory.py:41-69)
    ber_evm = float(np.asarray(theory.ber_vs_evm_qam(20 * np.log10(evm), M)))
    ber_th = float(np.asarray(theory.ber_vs_es_over_n0_qam(10 ** (snr / 10), M)))
    print("  %4.1f    %.3e     %.3e     %.3e" % (snr, ber, ber_evm, ber_th))

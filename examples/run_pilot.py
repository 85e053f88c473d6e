"""Multi-frame pilot-based receiver over an impaired link.

Workload parity: reference Scripts/run_pilot.py — generates a
SignalWithPilots TX (frame sequence + interleaved phase pilots), impairs it,
then runs the full pilot RX: frame sync, coarse FOE correction, data-aided
equalisation, pilot CPE, and frame-aware metrics across several frames.
Run: python examples/run_pilot.py
"""
import sys as _sys, pathlib as _pl
_sys.path.insert(0, str(_pl.Path(__file__).resolve().parents[1]))  # repo root
import numpy as np
import jax.random as jr
import qampy_tpu as qt
from qampy_tpu import equalisation, impairments, phaserec

fb = 24e9
sig = qt.SignalWithPilots(64, 2 ** 16, 1024, 32, nframes=3, nmodes=2, fb=fb, seed=22)
sig = sig.resample(2 * fb, beta=0.01)
sig = impairments.simulate_transmission(sig, snr=25, freq_off=100e6, lwdth=100e3,
                                        dgd=10e-12, modal_delay=(2000, 2000),
                                        roll_frame_sync=True, key=jr.PRNGKey(3))

found = sig.sync2frame(Ntaps=17)
print("frame sync:", bool(found), "shifts:", sig.shiftfctrs)
sig.corr_foe()
taps, eq_sig = equalisation.pilot_equaliser(sig, (1e-3, 1e-3), 45, foe_comp=False,
                                            methods=("cma", "sbd_data"))
cpe_sig, phase = phaserec.pilot_cpe(eq_sig, N=5, use_seq=False)
print("BER:", np.asarray(cpe_sig.cal_ber()))
print("GMI:", np.asarray(cpe_sig.cal_gmi()[0]))
print("SNR (dB):", 10 * np.log10(np.asarray(cpe_sig.est_snr())))

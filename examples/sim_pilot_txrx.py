"""Full pilot-based TX->RX simulation: frame sync, FOE, DA equalisation, CPE.

Workload parity: reference test/sim_pilot_txrx.py.
Run: python examples/sim_pilot_txrx.py
"""
import sys as _sys, pathlib as _pl
_sys.path.insert(0, str(_pl.Path(__file__).resolve().parents[1]))  # repo root
import numpy as np
import jax.random as jr
import qampy_tpu as qt
from qampy_tpu import equalisation, impairments, phaserec

sig = qt.SignalWithPilots(64, 2 ** 16, 2 ** 10, 32, nmodes=2, Mpilots=4,
                          nframes=3, fb=24e9, seed=4)
sig2 = sig.resample(sig.fb * 2, beta=0.01)
sig3 = impairments.simulate_transmission(sig2, snr=25, dgd=10e-12, freq_off=100e6,
                                         lwdth=100e3, modal_delay=(2000, 2000),
                                         key=jr.PRNGKey(4))
ok = sig3.sync2frame()
print("frame sync:", ok, "shifts:", sig3.shiftfctrs)
sig3.corr_foe()
wxy, eq_sig = equalisation.pilot_equaliser(sig3, (1e-3, 1e-3), 45,
                                           foe_comp=False, methods=("cma", "sbd"))
cpe_sig, ph = phaserec.pilot_cpe(eq_sig, N=5)
print("BER:", np.asarray(cpe_sig.cal_ber()))
print("GMI:", cpe_sig.cal_gmi()[0])

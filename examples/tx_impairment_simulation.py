"""TX impairment simulation through the full pilot RX (notebook workload).

Workload parity: reference Scripts/Notebooks/"Demo of transmitter
impairment simulation.ipynb" — build a SignalWithPilots frame from an
existing payload symbol array, pass it through the TX frontend model
(DAC bandwidth/ENOB response per polarisation, ideal driver amplifier,
Mach-Zehnder modulator response), add ASE loading noise, and recover with
the pilot DSP chain (sync2frame -> FOE -> pilot equaliser -> pilot CPE).
Run: python examples/tx_impairment_simulation.py
"""
import sys as _sys, pathlib as _pl
_sys.path.insert(0, str(_pl.Path(__file__).resolve().parents[1]))  # repo root
import numpy as np
import jax.numpy as jnp
import jax.random as jr
import qampy_tpu as qt
from qampy_tpu import equalisation, helpers, impairments, phaserec
from qampy_tpu.core import impairments as impair

M, N, P, R = 64, 2 ** 16, 1024, 32
nmodes, fb, roll_off = 2, 40e9, 0.5
N_pl = (N - P) * (R - 1) // R

# payload symbols first, then a pilot frame built FROM that payload
# (notebook cells 4-6: SignalQAMGrayCoded -> SignalWithPilots.from_symbol_array)
payload = qt.SignalQAMGrayCoded(M, N_pl, nmodes=nmodes, fb=fb, seed=2)
pilot_sig = qt.SignalWithPilots.from_symbol_array(payload, N, P, R, nframes=2)
sig = pilot_sig.resample(2 * fb, beta=roll_off, renormalise=True)

# deliberate bulk delay so frame sync has work to do (notebook: roll 10000)
sig = sig.replace(samples=jnp.roll(sig.samples, 10000, axis=-1))

# TX frontend: DAC (6-bit ENOB, 16 GHz bandwidth) -> driver amp -> MZM.
# Drive at 1.0 V on the normalised-Vpi transfer (Vpp/2Vpi ~ 0.5, a
# realistic operating point: the notebook's 3 V swing overdrives the
# wrapped MZM sine transfer and destroys the frame beyond recovery)
key = jr.PRNGKey(7)
dac_out = impair.sim_DAC_response(sig.samples, sig.fs, enob=6, key=key,
                                  cutoff=16e9)
amp_out = impair.ideal_amplifier_response(dac_out, out_volt=1.0)
mod_out = impair.modulator_response(amp_out)
sig = sig.replace(samples=jnp.asarray(mod_out))

# ASE loading at 35 dB OSNR-equivalent
sig = impairments.change_snr(sig, 35, key=jr.PRNGKey(8))

# pilot RX DSP
rx = sig.resample(2 * fb, beta=roll_off, renormalise=True)
rx = rx.replace(samples=helpers.normalise_and_center(rx.samples))
sync_ok = rx.sync2frame()   # mutates in place, like the reference
print("sync ok:", bool(sync_ok), "shift factors:", np.asarray(rx.shiftfctrs))
rx.corr_foe()
taps, eq_sig = equalisation.pilot_equaliser(rx, (1e-3, 1e-3), 45,
                                            foe_comp=False,
                                            methods=("cma", "sbd"))
cpe_sig, ph = phaserec.pilot_cpe(eq_sig, N=5, use_seq=False)
rx_payload = cpe_sig.get_data()
print("payload BER:", np.asarray(rx_payload.cal_ber()))
print("payload GMI:", np.asarray(rx_payload.cal_gmi()[0]))

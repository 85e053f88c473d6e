"""Serving a LONG capture (>=2^22 symbols) as chunked dispatches.

Production captures exceed what one dispatch should hold in device
memory; the serving pattern is:

* blind chain: split the capture into dispatch-sized chunks with a small
  overlap halo; each dispatch trains on its own 2^14-symbol prefix and
  the halo swallows the filter ramp + BPS edge window. Each
  blind dispatch keeps the blind receiver's inherent per-dispatch pi/2
  ambiguity (resolved downstream by differential coding — or use pilots).
* pilot chain: run the FULL chain (frame sync + training) once, then feed
  ``info["taps"]/info["shift"]/info["mode_order"]`` back through the
  ``forward.tracking`` entry for every further dispatch — zero prefix,
  phase-locked, frame-aligned (the reference's ``wxinit=`` warm-start
  pattern, qampy/equalisation.py:386-397).

Workload mirrors tests/test_long_capture.py at reduced size; run with
JAX_PLATFORMS=cpu or on the GPU.
"""
import numpy as np
import jax
import jax.numpy as jnp
import jax.random as jr

import qampy_tpu as qt
from qampy_tpu import impairments
from qampy_tpu.ops.chain import make_rx_chain
from qampy_tpu.ops.pilot_chain import make_pilot_rx_chain


def blind_chunked(Nsym=2 ** 20, chunk_sym=2 ** 18, M=16, os_=2):
    sig = qt.SignalQAMGrayCoded(M, Nsym, nmodes=2, fb=25e9, seed=21)
    s2 = impairments.change_snr(
        impairments.apply_PMD(sig.resample(os_ * sig.fb, beta=0.1),
                              np.pi / 5.6, 25e-12), 25, key=jr.PRNGKey(2))
    halo = 96 * os_
    Ep = jnp.pad(jnp.asarray(s2.samples), ((0, 0), (halo, halo + 16)))
    fwd = jax.jit(make_rx_chain(M=M, Ntaps=11, os=os_,
                                methods=("cma", "sbd"), mu=1e-3,
                                bps_angles=32, bps_N=8, TrSyms=2 ** 14))
    outs = []
    for c in range(Nsym // chunk_sym):
        seg = jax.lax.dynamic_slice(Ep, (0, c * chunk_sym * os_),
                                    (2, chunk_sym * os_ + 2 * halo + 16))
        outs.append(np.asarray(fwd(seg))[:, 96:96 + chunk_sym])
    out = np.concatenate(outs, axis=-1)
    rec = sig.replace(samples=jnp.asarray(out[:, 64:-64]))
    ser = np.asarray(rec.cal_ser())   # syncs delay/rotation/pairing itself
    print("blind chunked: %d symbols in %d dispatches, SER %s"
          % (out.shape[-1], Nsym // chunk_sym, ser))


def pilot_tracking(n_per=5, ndisp=3, M=64, F=2 ** 16, P=1024, R=32):
    NF = n_per * ndisp + 1
    sig = qt.SignalWithPilots(M, F, P, R, nframes=NF, nmodes=2,
                              fb=24e9, seed=7)
    s2 = impairments.simulate_transmission(
        sig.resample(2 * sig.fb, beta=0.1, renormalise=True),
        snr=28, lwdth=10e3, dgd=15e-12, theta=np.pi / 4.7,
        roll_frame_sync=True, key=jr.PRNGKey(9))
    E = jnp.asarray(s2.samples)
    fwd = make_pilot_rx_chain(
        np.asarray(sig.pilot_seq), np.asarray(sig.ph_pilots), F, R,
        os=2, M=M, nmodes=2, Ntaps=45, mu=(1e-3, 1e-3), Niter=30,
        cpe_avg=3, frames=tuple(range(n_per)), return_phase=False)
    data0, info = jax.jit(fwd)(E)                 # full chain once
    jtrk = jax.jit(fwd.tracking)
    datas = [data0]
    for d in range(1, ndisp):                     # zero-prefix dispatches
        dat, _ = jtrk(E, info["taps"], info["shift"],
                      mode_order=info["mode_order"],
                      _frame_base=d * n_per * F * 2)
        datas.append(dat)
    n_data = sig.get_data(frames=[0]).samples.shape[-1]
    for d, dat in enumerate(datas):
        fr = d * n_per
        rec = sig.get_data(frames=[fr]).replace(
            samples=jnp.asarray(np.asarray(dat)[:, :n_data]))
        ser = np.asarray(rec.cal_ser(synced=True))
        print("pilot dispatch %d (frames %d-%d): SER %s"
              % (d, fr, fr + n_per - 1, ser))


if __name__ == "__main__":
    blind_chunked()
    pilot_tracking()

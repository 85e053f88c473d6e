"""Production serving path: the fused single-dispatch RX chains.

Beyond-parity workload (no reference equivalent — the reference runs each
DSP stage as a separate host call): ``ops.make_rx_chain`` compiles the
whole blind receiver (two-stage MIMO equalisation, tap-frozen filtering,
blind phase search, derotation) into ONE jittable program, and
``ops.pilot_chain.make_pilot_rx_chain`` does the same for the complete
pilot receiver (frame sync, two-stage pilot equalisation, per-frame
filtering + pilot CPE). These are the programs bench.py measures. Both
chains also expose planes serving entries (``forward.planes`` /
``.tracking_planes``: float32 real/imag planes in and out).
Run: python examples/fused_rx_serving.py  (demo sizes)
"""
import _common  # noqa: F401
import numpy as np
import jax
import jax.numpy as jnp
import jax.random as jr
import qampy_tpu as qt
from qampy_tpu import impairments
from qampy_tpu.ops.chain import make_rx_chain
from qampy_tpu.ops.pilot_chain import make_pilot_rx_chain

# ---- blind chain: dual-pol 64-QAM MCMA -> MDDMA -> BPS ----------------
sig = qt.SignalQAMGrayCoded(64, 2 ** 15, nmodes=2, fb=25e9, seed=5)
s2 = sig.resample(50e9, beta=0.1, renormalise=True)
s2 = impairments.simulate_transmission(s2, snr=33, lwdth=20e3,
                                       dgd=20e-12, theta=np.pi / 5.6,
                                       key=jr.PRNGKey(1))
fwd = jax.jit(make_rx_chain(M=64, Ntaps=17, os=2, bps_angles=32, bps_N=10,
                            block_size=128, TrSyms=2 ** 13))
print("blind chain backend:", fwd.__wrapped__.backend_info)
out = fwd(jnp.asarray(s2.samples))
rec = sig.replace(samples=out[:, 200:-200])
print("blind chain SER:", np.asarray(rec.cal_ser()))

# decimated carrier recovery: the WHOLE phase search runs on every 8th
# equalised symbol and the derotation interpolates the unwrapped phase —
# no per-symbol phase-search work
fwd_dec = jax.jit(make_rx_chain(M=64, Ntaps=17, os=2, bps_angles=64,
                                bps_N=10, block_size=128, TrSyms=2 ** 13,
                                bps_mode="decimated"))
out_dec = fwd_dec(jnp.asarray(s2.samples))
rec_dec = sig.replace(samples=out_dec[:, 200:-200])
print("decimated-BPS chain SER:", np.asarray(rec_dec.cal_ser()))

# ---- pilot chain: full SignalWithPilots receiver, 3 frames ------------
psig = qt.SignalWithPilots(64, 2 ** 14, 512, 32, nframes=5, nmodes=2,
                           fb=24e9, seed=7)
p2 = psig.resample(2 * psig.fb, beta=0.1, renormalise=True)
p2 = impairments.simulate_transmission(p2, snr=30, lwdth=20e3, dgd=20e-12,
                                       theta=np.pi / 4.3,
                                       roll_frame_sync=True,
                                       key=jr.PRNGKey(2))
pfwd = jax.jit(make_pilot_rx_chain(
    np.asarray(psig.pilot_seq), np.asarray(psig.ph_pilots),
    psig.frame_len, psig.pilot_ins_rat, os=2, M=64, nmodes=2,
    Ntaps=17, Niter=30, cpe_avg=3, frames=(0, 1, 2),
    return_phase=False))
data, info = pfwd(jnp.asarray(p2.samples))
pout = psig.get_data(frames=[0, 1, 2]).replace(samples=data)
print("pilot sync corr: %.0f (threshold 120)" % float(info["sync_corr"]))
print("pilot chain BER:", np.asarray(pout.cal_ber(synced=True)))

# steady-state tracking: reuse the found taps/shift, skip sync + training
# (zero-prefix warm start)
track = jax.jit(pfwd.__wrapped__.tracking)
data2, _ = track(jnp.asarray(p2.samples), info["taps"], info["shift"],
                 info["mode_order"])
print("tracking output identical:", bool(jnp.all(data2 == data)))

# planes serving (the bench.py path): the capture ships as float32
# planes, the payload comes back as (dr, di) planes — identical to the
# complex entries
E = np.asarray(p2.samples)
track_p = jax.jit(pfwd.__wrapped__.tracking_planes)
(dr, di), _ = track_p(jnp.asarray(E.real.astype(np.float32)),
                      jnp.asarray(E.imag.astype(np.float32)),
                      info["taps"], info["shift"], info["mode_order"])
print("planes tracking identical:",
      bool(jnp.all((dr + 1j * di) == data)))

# closed-form pilot training: eq_trainer="ls" replaces the iterative LMS
# trainings with one Gram matmul + solve per mode (the config the
# mesh-sharded receiver's shard_prefix=True path uses)
pfwd_ls = jax.jit(make_pilot_rx_chain(
    np.asarray(psig.pilot_seq), np.asarray(psig.ph_pilots),
    psig.frame_len, psig.pilot_ins_rat, os=2, M=64, nmodes=2,
    Ntaps=17, Niter=30, cpe_avg=3, frames=(0, 1, 2),
    return_phase=False, eq_trainer="ls"))
data_ls, info_ls = pfwd_ls(jnp.asarray(p2.samples))
pout_ls = psig.get_data(frames=[0, 1, 2]).replace(samples=data_ls)
print("pilot chain (LS trainer) BER:",
      np.asarray(pout_ls.cal_ber(synced=True)))

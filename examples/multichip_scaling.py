"""Time-sharded multi-device RX chain over a jax mesh.

Shards a dual-pol 64-QAM waveform over all available devices, trains the
equaliser data-parallel with phase-aligned tap averaging, and runs halo-
exchange filtering + BPS. On a CPU host set
XLA_FLAGS=--xla_force_host_platform_device_count=8 to simulate 8 devices.
Run: python examples/multichip_scaling.py
"""
import sys as _sys, pathlib as _pl
_sys.path.insert(0, str(_pl.Path(__file__).resolve().parents[1]))  # repo root
import numpy as np
import jax
import jax.random as jr
import qampy_tpu as qt
from qampy_tpu import impairments
from qampy_tpu.parallel import make_mesh, sharded

ndev = len(jax.devices())
mesh = make_mesh(ndev)
print("mesh:", mesh)

fb = 25e9
sig = qt.SignalQAMGrayCoded(64, 2 ** 16, nmodes=2, fb=fb, seed=1)
up = sig.resample(2 * fb, beta=0.1)
s = impairments.apply_phase_noise(up, 20e3, key=jr.PRNGKey(5))
s = impairments.change_snr(s, 35, key=jr.PRNGKey(3))
s = impairments.apply_PMD(s, np.pi / 5.6, 50e-12)

E = sharded.shard_signal(np.asarray(s), mesh)
chain = sharded.make_sharded_rx_chain(mesh, os=2, mu1=1e-3, mu2=1e-3, M=64,
                                      Ntaps=17, methods=("cma", "rde"),
                                      rounds=2, bps_angles=64, bps_N=14)
Eout, ph, evm = chain(E)
out = sig.replace(samples=np.asarray(Eout))
print("EVM:", float(evm))
print("SER:", np.asarray(out.cal_ser()))

# ---- decimated carrier recovery per shard (the single-device chain's
# decimated mode on the mesh: every 8th symbol, decimated-domain halos,
# exact cross-shard unwrap, piecewise-linear derotation) -----------------
chain_dec = sharded.make_sharded_rx_chain(
    mesh, os=2, mu1=1.9e-3, mu2=1.9e-3, M=64, Ntaps=17,
    methods=("mcma", "mddma"), rounds=2, bps_angles=64, bps_N=14,
    block_size=128, bps_mode="decimated")
Eout_d, ph_d, evm_d = chain_dec(E)
print("decimated SER:", np.asarray(
    sig.replace(samples=np.asarray(Eout_d)).cal_ser()))

# ---- frame-parallel pilot receiver with the DISTRIBUTED cold-start
# prefix (window-search chunks per device, per-mode alignment/trainings
# on device groups) and the closed-form LS pilot trainer -----------------
psig = qt.SignalWithPilots(64, 2 ** 14, 512, 32, nframes=ndev + 2,
                           nmodes=2, fb=24e9, seed=7)
p2 = psig.resample(2 * psig.fb, beta=0.1, renormalise=True)
p2 = impairments.simulate_transmission(p2, snr=30, lwdth=20e3,
                                       roll_frame_sync=True,
                                       key=jr.PRNGKey(11))
pchain = sharded.make_sharded_pilot_rx(
    mesh, np.asarray(psig.pilot_seq), np.asarray(psig.ph_pilots),
    psig.frame_len, psig.pilot_ins_rat, frames_per_device=1,
    shard_prefix=True, os=2, M=64, nmodes=2, Ntaps=17, Niter=30,
    cpe_avg=3, eq_trainer="ls")
import jax.numpy as jnp
pdata, pshift, pcorr = pchain(jnp.asarray(p2.samples))
pout = psig.get_data().replace(samples=jnp.asarray(np.asarray(pdata)))
print("sharded-prefix pilot SER:", np.asarray(pout.cal_ser(synced=True)))

"""Serving arbitrary (non-grid) and probabilistically shaped alphabets.

No reference-script equivalent exists: the reference handles arbitrary
alphabets only through its slow any-M python search
(qampy/core/pythran_dsp.py:47-85). Here the same fused serving chain
accepts ``symbols=`` (geometric shaping / APSK / warped grids):

* blind chain with a radially warped 64-point alphabet — the analytic
  per-axis grid decision cannot apply, so the BPS decision runs the
  O(M) search and the blind constants are derived from the alphabet's
  own moments;
* Maxwell-Boltzmann PS-shaped 64-QAM — the support stays a grid, so the
  analytic grid decisions apply;
* a 256-point warped alphabet through the PILOT chain — data-aided
  training and the alphabet-free payload path serve alphabets the blind
  stages cannot lock onto.

Run: python examples/general_alphabet_serving.py
"""
import _common  # noqa: F401
import numpy as np
import jax
import jax.numpy as jnp
import jax.random as jr

import qampy_tpu as qt
from qampy_tpu import theory
from qampy_tpu.ops.chain import make_rx_chain
from qampy_tpu.ops.pilot_chain import make_pilot_rx_chain
from qampy_tpu.theory import cal_symbols_qam, cal_scaling_factor_qam, warped_qam


def ser_vs(out, ref, const, trim=300):
    """Nearest-point SER: per-mode min over pi/2 rotations x offsets
    (each mode's BPS carries an INDEPENDENT pi/2 ambiguity), pol pairing
    restricted to permutations."""
    import itertools
    o = np.asarray(out)[:, trim:-trim]
    nm = o.shape[0]
    ser_mr = np.ones((nm, nm))
    for m in range(nm):
        for rm in range(nm):
            for rot in range(4):
                for off in (3, 4, 5):
                    r = ref[rm][trim + off:trim + off + o.shape[1]]
                    d = o[m] * (1j ** rot)
                    dec = np.argmin(np.abs(d[:, None] - const[None, :]), -1)
                    rdec = np.argmin(np.abs(r[:, None] - const[None, :]), -1)
                    ser_mr[m, rm] = min(ser_mr[m, rm],
                                        float(np.mean(dec != rdec)))
    return min(np.mean([ser_mr[m, p[m]] for m in range(nm)])
               for p in itertools.permutations(range(nm)))


def tx(const, L, seed, probs=None, snr=35):
    rng = np.random.default_rng(seed)
    M = const.shape[0]
    idx = (rng.choice(M, size=(2, L), p=probs) if probs is not None
           else rng.integers(0, M, size=(2, L)))
    syms = const[idx]
    sig = qt.SymbolOnlySignal.from_symbol_array(syms, coded_symbols=const,
                                                fb=25e9)
    s2 = sig.resample(50e9, beta=0.1, renormalise=True)
    # simulate_transmission applies the reference's canonical impairment
    # ORDER (phase noise -> AWGN -> PMD): laser phase is per SOURCE, so
    # each equalised output carries one phase trajectory the BPS can
    # track. (Independent per-pol phase noise applied AFTER the PMD mix
    # puts two different phase processes inside each output — untrackable
    # by per-output carrier recovery, and not how a coherent link works.)
    s2 = qt.impairments.simulate_transmission(
        s2, snr=snr, lwdth=20e3, dgd=20e-12, theta=np.pi / 5.6,
        key=jr.PRNGKey(seed))
    return np.asarray(s2).astype(np.complex64), syms


# ---- 1. warped (non-grid) 64-point alphabet, blind fused chain ---------
const = warped_qam(64)
E, syms = tx(const, 2 ** 16, seed=3)
# modulus-only stages: decision-directed second stages (sbd/mddma) on a
# NON-GRID alphabet are fragile before carrier recovery (the warped
# points' decisions are marginal under un-recovered phase: seed-dependent
# one-pol divergence) — the robust blind recipe for gen alphabets is
# modulus criteria + two-stage BPS with the wide (N1=60) slip-suppressing
# coarse window. A SHORT training prefix (2^14) keeps mcma->sbd viable.
fwd = make_rx_chain(Ntaps=17, os=2, methods=("mcma", "mcma"), mu=1.9e-3,
                    bps_angles=64, bps_N=14, block_size=128,
                    symbols=const, bps_mode="twostage", TrSyms=2**15)
print("warped-64 backend:", {k: fwd.backend_info[k]
                             for k in ("family", "grid_kind")})
ser = ser_vs(jax.jit(fwd)(jnp.asarray(E)), syms, const)
print("warped-64 blind chain SER: %.2e" % ser)
assert ser < 1e-2

# ---- 2. MB-PS 64-QAM (grid support -> fully fused path) ----------------
base = (cal_symbols_qam(64) / np.sqrt(cal_scaling_factor_qam(64))
        ).astype(np.complex64)
lv, pl = theory.cal_ps_probablts(base, 0.5)
probs = pl[np.searchsorted(lv, base.real)] * pl[np.searchsorted(lv, base.imag)]
probs = probs / probs.sum()
coded = (base / np.sqrt(np.sum(probs * np.abs(base) ** 2))).astype(np.complex64)
H = float(-np.sum(probs * np.log2(probs)))
E, syms = tx(coded, 2 ** 16, seed=5, probs=probs)
fwd = make_rx_chain(Ntaps=17, os=2, methods=("mcma", "sbd"), mu=1.9e-3,
                    bps_angles=64, bps_N=14, block_size=128,
                    symbols=coded, bps_mode="twostage", TrSyms=2**15)
ser = ser_vs(jax.jit(fwd)(jnp.asarray(E)), syms, coded)
print("MB-PS 64-QAM (H=%.2f bits) blind chain SER: %.2e" % (H, ser))
assert ser < 1e-2

# ---- 3. 256-point warped payload via the pilot chain -------------------
FRAME, SEQ, INS = 2 ** 14, 512, 32
c256 = warped_qam(256)
rng = np.random.default_rng(6)
npl = (FRAME - SEQ) * (INS - 1) // INS
pay = c256[rng.integers(0, 256, size=(2, npl))]
pays = qt.SymbolOnlySignal.from_symbol_array(pay, coded_symbols=c256, fb=24e9)
sig = qt.SignalWithPilots.from_symbol_array(pays, FRAME, SEQ, INS, nframes=4)
s2 = sig.resample(2 * sig.fb, beta=0.1, renormalise=True)
s2 = qt.impairments.simulate_transmission(s2, snr=40, dgd=20e-12,
                                          theta=np.pi / 4.3, lwdth=20e3,
                                          roll_frame_sync=True,
                                          key=jr.PRNGKey(9))
pfwd = make_pilot_rx_chain(np.asarray(sig.pilot_seq),
                           np.asarray(sig.ph_pilots), sig.frame_len,
                           sig.pilot_ins_rat, os=2, M=256, nmodes=2,
                           Ntaps=17, Niter=30, cpe_avg=3, frames=(0, 1))
d, info = jax.jit(pfwd)(jnp.asarray(s2.samples))
ref = np.asarray(sig.get_data(frames=[0, 1]).samples)
dec = np.argmin(np.abs(np.asarray(d)[..., None] - c256[None, None, :]), -1)
rdec = np.argmin(np.abs(ref[..., None] - c256[None, None, :]), -1)
print("warped-256 payload via pilot chain SER: %s"
      % np.mean(dec != rdec, axis=-1))
assert np.all(np.mean(dec != rdec, axis=-1) < 1e-2)
print("general-alphabet serving OK")

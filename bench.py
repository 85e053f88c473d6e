"""Benchmark: the two served receivers on one device, each run gated.

Workloads (the reference's canonical receivers):

* blind chain (ops/chain.make_rx_chain): dual-pol 64-QAM, 2 samples per
  symbol, MCMA -> MDDMA adaptive 2x2 MIMO equalisation trained on a 2^14
  symbol prefix + blind phase search, on a 2^20-symbol capture with
  20 kHz phase noise, PMD and 35 dB SNR (reference
  Scripts/64_qam_equalisation.py:15-28); also its tracking entry with the
  frozen taps of a full run;
* pilot chain (ops/pilot_chain.make_pilot_rx_chain): SignalWithPilots(64,
  2^16, 1024, 32) dual-pol at 24 GBd, 244 frames captured, 240 frames
  demodulated per dispatch (reference test/sim_pilot_txrx.py); LS and
  LMS pilot trainers, and its tracking entry.

Every attempt prints one line on stderr with its gate value and rate, the
winner's numbers go into the JSON line on stdout. Throughput is Msym/s of
recovered symbols per device: both modes of the blind capture, payload
symbols only for the pilot chain. Times are host-clock medians around
``block_until_ready``. The script needs an accelerator: on the CPU it exits
with an error.

Run: python bench.py
"""
import json
import sys
import time
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

#: SER gate of every blind run: the reference blind-equaliser tolerance
#: (SER ~ 0 at high SNR) held to at most one error in 10^5 symbols
BLIND_SER_GATE = 1e-5
#: BER gate of every pilot run (reference test/test_pilot_signal.py:103-118)
PILOT_BER_GATE = 1e-5
#: weakest pilot autocorrelation peak accepted as a frame sync
SYNC_CORR_MIN = 120
#: symbols per mode of the blind capture
BLIND_NSYM = 2 ** 20
#: the blind chain's bench configuration
BLIND_CHAIN = dict(M=64, Ntaps=17, os=2, methods=("mcma", "mddma"),
                   mu=1.9e-3, bps_angles=64, block_size=256, TrSyms=2 ** 14)
#: pilot layout (M, frame_len, pilot sequence length, pilot insertion ratio)
PILOT_LAYOUT = (64, 2 ** 16, 1024, 32)
#: frames in the pilot capture, and frames demodulated per dispatch
PILOT_FRAMES, PILOT_DISPATCH = 244, 240
#: recovered symbols trimmed at each capture edge by the blind SER gate
EDGE = 200


def make_tx(Nsym=2 ** 20, M=64, fb=25e9, seed=1, const=None, probs=None,
            snr=35):
    """Host-side TX synthesis: QAM (or a caller-supplied ``const``
    alphabet, optionally with non-uniform draw ``probs`` — probabilistic
    shaping), RRC 2x oversampling, 20 kHz phase noise, AWGN at 35 dB, PMD.
    Pure numpy on the host. Returns (capture (2, 2*Nsym) complex64,
    transmitted symbols (2, Nsym), power-normalised alphabet)."""
    from qampy_tpu.theory import cal_symbols_qam, cal_scaling_factor_qam, gray_code_qam
    rng = np.random.default_rng(seed)
    if const is not None:
        const = np.asarray(const).astype(np.complex64).reshape(-1)
        M = const.shape[0]
    else:
        const = (cal_symbols_qam(M) / np.sqrt(cal_scaling_factor_qam(M))).astype(np.complex64)
    g = gray_code_qam(M)
    u = np.zeros_like(g)
    u[g] = np.arange(M)
    coded = const  # power-normalised constellation in gray order
    if probs is not None:
        probs = np.asarray(probs, dtype=np.float64)
        probs = probs / probs.sum()
        sym_idx = rng.choice(M, size=(2, Nsym), p=probs)
        # shaped draws change the mean power; re-normalise the alphabet so
        # the transmitted signal keeps unit symbol power
        p_mean = np.sum(probs * np.abs(const) ** 2)
        coded = (const / np.sqrt(p_mean)).astype(np.complex64)
    else:
        sym_idx = rng.integers(0, M, size=(2, Nsym))
    syms = coded[sym_idx]
    # zero-insertion upsample + RRC shaping (frequency domain)
    os = 2
    L = Nsym * os
    up = np.zeros((2, L), dtype=np.complex64)
    up[:, ::os] = syms
    f = np.fft.fftfreq(L) * (os * fb)
    T = 1 / fb
    beta = 0.1
    af = np.abs(f)
    rc = np.zeros(L)
    rc[af <= (1 - beta) / (2 * T)] = T
    mask = (af > (1 - beta) / (2 * T)) & (af <= (1 + beta) / (2 * T))
    rc[mask] = T / 2 * (1 + np.cos(np.pi * T / beta * (af[mask] - (1 - beta) / (2 * T))))
    h = np.sqrt(rc)
    h /= h.max()
    sig = np.fft.ifft(np.fft.fft(up, axis=-1) * h, axis=-1).astype(np.complex64)
    sig /= np.sqrt(np.mean(np.abs(sig) ** 2, axis=-1, keepdims=True))
    # phase noise (Wiener, 20 kHz combined linewidth)
    var = 2 * np.pi * 20e3 / (os * fb)
    ph = np.cumsum(rng.normal(scale=np.sqrt(var), size=(2, L)), axis=-1)
    sig = sig * np.exp(1j * ph).astype(np.complex64)
    # AWGN (os-aware; default 35 dB)
    n_amp = 10 ** (-snr / 20) * np.sqrt(os)
    sig = sig + (n_amp / np.sqrt(2) * (rng.standard_normal((2, L)) +
                 1j * rng.standard_normal((2, L)))).astype(np.complex64)
    # PMD: rotation + DGD in the frequency domain
    theta = np.pi / 5.6
    t_dgd = 50e-12
    omega = 2 * np.pi * np.linspace(-os * fb / 2, os * fb / 2, L, endpoint=False)
    R = np.array([[np.cos(theta), -np.sin(theta)], [np.sin(theta), np.cos(theta)]])
    Sf = np.fft.fftshift(np.fft.fft(np.fft.ifftshift(sig, axes=-1), axis=-1), axes=-1)
    Sf = R @ Sf
    Sf *= np.exp(np.array([-1, 1])[:, None] * 1j * omega * t_dgd / 2)
    Sf = R.T @ Sf
    sig = np.fft.fftshift(np.fft.ifft(np.fft.ifftshift(Sf, axes=-1), axis=-1), axes=-1)
    return sig.astype(np.complex64), syms.astype(np.complex64), coded


def blind_chain(bps_mode, **kw):
    """The blind chain at the bench configuration in ``bps_mode``."""
    from qampy_tpu.ops.chain import make_rx_chain
    # decimated16: the first/last N*16 symbols carry no full window; N=12
    # keeps 12*16=192 inside the gate's 200-symbol trim
    bps_N = 12 if bps_mode == "decimated16" else 14
    return make_rx_chain(bps_N=bps_N, bps_mode=bps_mode, **BLIND_CHAIN, **kw)


def blind_ser(out, syms, const):
    """SER of recovered symbols ``out`` against the transmitted ``syms``.

    Nearest-point decisions on the (square) grid of ``const``, minimised
    per mode over pi/2 rotation x transmitted mode x taps-centre offset
    (3, 4, 5 symbols); ``EDGE`` symbols trimmed at each end."""
    levels = np.unique(np.round(np.asarray(const).real, 6))
    return float(_blind_ser(out, syms, float(levels[1] - levels[0]),
                            float(levels[0]), int(levels.size)))


@partial(jax.jit, static_argnames=("d0", "lo", "n"))
def _blind_ser(out, ref, d0, lo, n):
    o = out[:, EDGE:-EDGE]
    L = o.shape[1]

    def decide(z):
        q = lambda x: lo + d0 * jnp.clip(jnp.round((x - lo) / d0), 0, n - 1)
        return q(z.real) + 1j * q(z.imag)

    sers = []
    for m in range(o.shape[0]):
        decs = [decide(o[m] * (1j ** rot)) for rot in range(4)]
        cand = []
        for refm in range(ref.shape[0]):
            for off in (3, 4, 5):
                rseg = jax.lax.dynamic_slice(ref, (refm, EDGE + off),
                                             (1, L))[0]
                cand += [jnp.mean((jnp.abs(d - rseg) > d0 / 4)
                                  .astype(jnp.float32)) for d in decs]
        sers.append(jnp.min(jnp.stack(cand)))
    return jnp.mean(jnp.stack(sers))


def make_pilot_tx(nframes=PILOT_FRAMES, snr=35, seed=3):
    """Pilot-chain capture synthesised with JAX on the default device.

    SignalWithPilots(*PILOT_LAYOUT) dual-pol at 24 GBd (reference
    test/sim_pilot_txrx.py), RRC 2x oversampling, 20 kHz phase noise,
    20 ps DGD, AWGN at ``snr`` dB, the frames rolled so the capture starts
    inside a frame. Returns a dict: ``pr``/``pi`` float32 capture planes,
    ``seq``/``ph`` host pilot arrays, ``coded`` the alphabet, ``idx_tx``
    the transmitted payload indices of one frame (every frame repeats it),
    ``bits`` the gray bit table, and the layout."""
    import jax.random as jr
    import qampy_tpu as qt
    M, F, P, R = PILOT_LAYOUT
    sig = qt.SignalWithPilots(M, F, P, R, nframes=int(nframes), nmodes=2,
                              fb=24e9, seed=seed)
    s2 = sig.resample(2 * sig.fb, beta=0.1, renormalise=True)
    s2 = qt.impairments.simulate_transmission(
        s2, snr=snr, lwdth=20e3, dgd=20e-12, theta=np.pi / 4.3,
        roll_frame_sync=True, key=jr.PRNGKey(5))
    E = jnp.asarray(s2.samples).astype(jnp.complex64)
    coded = np.asarray(sig.coded_symbols).astype(np.complex64)
    pay = jnp.asarray(sig.get_data(frames=[0]).samples)
    idx_tx = jnp.argmin(jnp.abs(pay[:, :, None] - coded[None, None, :]),
                        axis=-1).astype(jnp.int32)
    return dict(pr=E.real, pi=E.imag, seq=np.asarray(sig.pilot_seq),
                ph=np.asarray(sig.ph_pilots), coded=coded, idx_tx=idx_tx,
                bits=np.asarray(sig._symbols_obj._encoding).astype(np.uint8),
                M=M, frame_len=F, ins_rat=R)


def pilot_chain_kwargs(tx, eq_trainer="lms"):
    """make_pilot_rx_chain keyword arguments of the bench configuration,
    all but the pilots, the layout and ``frames``."""
    return dict(os=2, M=tx["M"], nmodes=2, sync_Ntaps=17, sync_mu=5e-3,
                sync_Niter=10, Ntaps=45, mu=(1e-3, 1e-3), Niter=30,
                cpe_avg=3, block_size=256, return_phase=False,
                frames_unroll=4, eq_trainer=eq_trainer)


def pilot_chain(tx, nframes=PILOT_DISPATCH, eq_trainer="lms"):
    """The pilot chain at the bench configuration, ``nframes`` frames per
    dispatch."""
    from qampy_tpu.ops.pilot_chain import make_pilot_rx_chain
    return make_pilot_rx_chain(tx["seq"], tx["ph"], tx["frame_len"],
                               tx["ins_rat"],
                               frames=tuple(range(int(nframes))),
                               **pilot_chain_kwargs(tx, eq_trainer))


def pilot_ber(dr, di, tx):
    """(BER, SER) of demodulated payload planes ``dr``/``di`` against the
    transmitted payload. Bit errors are counted through an (M, M)
    Hamming-distance table indexed by (received, sent) symbol pairs."""
    bits = tx["bits"].astype(np.float32)
    ham = (bits[:, None, :] != bits[None, :, :]).sum(-1).astype(np.float32)
    ber, ser = _pilot_ber(dr, di, tx["idx_tx"], tx["coded"], ham.reshape(-1))
    return float(ber), float(ser)


@jax.jit
def _pilot_ber(dr, di, idx_tx, coded, ham):
    from qampy_tpu.core.metrics import decision_idx
    M = coded.shape[0]
    nb = np.log2(M)
    it = jnp.tile(idx_tx, (1, dr.shape[-1] // idx_tx.shape[-1]))
    idx_rx = decision_idx(dr + 1j * di, coded)
    ser = jnp.mean((idx_rx != it).astype(jnp.float32))
    return jnp.mean(ham[idx_rx * M + it]) / nb, ser


def device_info():
    """(platform, device_kind, device count) as JAX reports them."""
    d = jax.devices()
    return d[0].platform, d[0].device_kind, len(d)


def timed(f, *args, reps=5):
    """Median and minimum seconds of ``f(*args)`` over ``reps`` calls after
    one warm-up call, each ended by ``block_until_ready``."""
    jax.block_until_ready(f(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(f(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)), float(np.min(ts))


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def _blind_attempts(P, syms, const, res):
    nsym = 2 * BLIND_NSYM
    win = None
    for mode in ("decimated16", "decimated", "single"):
        fwd = blind_chain(mode)
        run = jax.jit(fwd.planes)
        outr, outi = run(P)
        ser = blind_ser(outr + 1j * outi, syms, const)
        med, best = timed(run, P)
        ok = ser <= BLIND_SER_GATE
        log("blind %-12s SER=%.3e gate=%.0e %s  %.2f Msym/s (median %.3f ms)"
            % (mode, ser, BLIND_SER_GATE, "pass" if ok else "FAIL",
               nsym / med / 1e6, med * 1e3))
        if ok and win is None:
            win = fwd
            res.update(blind_mode=mode, blind_ser=ser,
                       blind_msym_s=nsym / med / 1e6)
    if win is None:
        return
    (outr, outi), w2 = jax.jit(win.planes_with_taps)(P)
    trk = jax.jit(win.tracking_planes)
    tr, ti = trk(P, w2)
    ser = blind_ser(tr + 1j * ti, syms, const)
    med, _ = timed(trk, P, w2)
    log("blind tracking SER=%.3e %s  %.2f Msym/s"
        % (ser, "pass" if ser <= BLIND_SER_GATE else "FAIL",
           nsym / med / 1e6))
    if ser <= BLIND_SER_GATE:
        res.update(blind_tracking_ser=ser,
                   blind_tracking_msym_s=nsym / med / 1e6)


def _pilot_attempts(tx, res):
    npay = tx["idx_tx"].shape[-1] * 2 * PILOT_DISPATCH
    win = None
    for tr in ("ls", "lms"):
        fwd = pilot_chain(tx, eq_trainer=tr)
        run = jax.jit(fwd.planes)
        (dr, di), info = run(tx["pr"], tx["pi"])
        ber, _ = pilot_ber(dr, di, tx)
        corr = float(info["sync_corr"])
        med, _ = timed(run, tx["pr"], tx["pi"])
        ok = ber <= PILOT_BER_GATE and corr >= SYNC_CORR_MIN
        log("pilot %-3s %d frames BER=%.3e sync_corr=%.1f %s  %.2f Msym/s"
            % (tr, PILOT_DISPATCH, ber, corr, "pass" if ok else "FAIL",
               npay / med / 1e6))
        if ok and win is None:
            win = (fwd, info)
            res.update(pilot_trainer=tr, pilot_ber=ber,
                       pilot_msym_s=npay / med / 1e6,
                       pilot_frames_per_dispatch=PILOT_DISPATCH)
    if win is None:
        return
    fwd, info = win
    trk = jax.jit(fwd.tracking_planes)
    args = (tx["pr"], tx["pi"], info["taps"], info["shift"],
            info["mode_order"])
    (dr, di), _ = trk(*args)
    ber, _ = pilot_ber(dr, di, tx)
    med, _ = timed(trk, *args)
    log("pilot tracking BER=%.3e %s  %.2f Msym/s"
        % (ber, "pass" if ber <= PILOT_BER_GATE else "FAIL",
           npay / med / 1e6))
    if ber <= PILOT_BER_GATE:
        res.update(pilot_tracking_ber=ber,
                   pilot_tracking_msym_s=npay / med / 1e6)


def main():
    from qampy_tpu import compile_cache
    cache = compile_cache.enable()
    platform, kind, count = device_info()
    log("device: platform=%s kind=%s count=%d  jax %s  cache %s"
        % (platform, kind, count, jax.__version__, cache))
    if platform == "cpu":
        log("bench.py measures an accelerator; JAX found none")
        return 1
    res = {"device": {"platform": platform, "kind": kind, "count": count}}
    E, syms, const = make_tx(BLIND_NSYM)
    P = jax.device_put(np.concatenate([E.real, E.imag]).astype(np.float32))
    _blind_attempts(P, jax.device_put(syms), const, res)
    _pilot_attempts(make_pilot_tx(), res)
    print(json.dumps(res))
    return 0 if "blind_msym_s" in res and "pilot_msym_s" in res else 1


if __name__ == "__main__":
    sys.exit(main())

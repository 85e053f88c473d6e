"""Long-capture serving robustness: >=2^22 symbols through the blind and
pilot chains as CHUNKED dispatches with state carry.

Serving never sees one giant dispatch: a capture is split into
dispatch-sized chunks and receiver state — blind: none needed beyond the per-chunk
training prefix; pilot: taps/shift/mode_order through the ``tracking``
entry — carries across chunks. These tests pin that the chunked outputs
are contiguous and recover the TX data across EVERY chunk boundary.
Workload scale: reference Scripts/64_qam_equalisation.py / sim_pilot_txrx
captures, extended to multi-dispatch length.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import jax.random as jr

import qampy_tpu as qt
from qampy_tpu import impairments
from qampy_tpu.ops.chain import make_rx_chain
from qampy_tpu.ops.pilot_chain import make_pilot_rx_chain


def _dec_idx(z, const):
    return np.argmin(np.abs(np.asarray(z)[:, None] - const[None, :]), axis=1)


def _find_alignment(out, ref, const, probe=2 ** 15, max_off=8):
    """One-time alignment of a recovered stream against TX symbols.

    The MIMO equaliser converges to an arbitrary small integer delay, an
    independent pi/2 rotation PER MODE (docs/PERFORMANCE.md, gates) and
    possibly swapped polarisations. Estimated ONCE on a
    probe window and then applied globally — so a chunk that seams with a
    different delay/rotation fails its SER check instead of being
    re-synced away.
    Returns (perm, offs, rots).
    """
    best = (1.0, None)
    for perm in ([0, 1], [1, 0]):
        offs, rots, sers = [], [], []
        for m in range(2):
            cand = []
            for off in range(-max_off, max_off + 1):
                o = np.asarray(out[perm[m]])[max_off + off:
                                             max_off + off + probe]
                r = np.asarray(ref[m])[max_off:max_off + probe]
                ridx = _dec_idx(r, const)
                for k in range(4):
                    s = np.mean(_dec_idx(o * 1j ** k, const) != ridx)
                    cand.append((s, off, k))
            s, off, k = min(cand)
            offs.append(off)
            rots.append(k)
            sers.append(s)
        tot = float(np.mean(sers))
        if tot < best[0]:
            best = (tot, (perm, offs, rots))
    assert best[1] is not None
    return best[1]


def _ser_aligned(out, ref, const, align, sl):
    """Per-pair SER on slice ``sl`` under a FIXED alignment."""
    perm, offs, rots = align
    n = np.asarray(ref).shape[-1]
    sers = []
    for m in range(2):
        lo, hi = sl.start or 0, sl.stop if sl.stop is not None else n
        hi = hi if hi > 0 else n + hi
        o = np.asarray(out[perm[m]])[lo + offs[m]: hi + offs[m]] * 1j ** rots[m]
        r = np.asarray(ref[m])[lo:hi]
        sers.append(np.mean(_dec_idx(o, const) != _dec_idx(r, const)))
    return float(np.mean(sers))


class TestLongCaptureBlind:
    def test_chunked_blind_chain_4M_symbols(self):
        """2^22 symbols (2^23 samples) in 4 chunked dispatches of 2^21
        samples each; chunks overlap by the filter+BPS edge so every
        payload symbol is recovered exactly once."""
        M, os_, Ntaps, bps_N = 16, 2, 11, 8
        Nsym = 2 ** 22
        sig = qt.SignalQAMGrayCoded(M, Nsym, nmodes=2, fb=25e9, seed=21)
        s2 = sig.resample(os_ * sig.fb, beta=0.1)
        s2 = impairments.apply_PMD(s2, np.pi / 5.6, 25e-12)
        s2 = impairments.change_snr(s2, 25, key=jr.PRNGKey(2))
        E = jnp.asarray(s2.samples)

        chunk_sym = 2 ** 20                   # symbols per dispatch
        # overlap halo covering the filter ramp + BPS edge window on each
        # side; the capture is zero-padded so every chunk has identical
        # geometry (one compiled program) and the final filter/BPS tail
        # falls into padding instead of truncating the last symbols
        halo_sym = 96
        halo = halo_sym * os_
        Ep = jnp.pad(E, ((0, 0), (halo, halo + 16)))
        fwd = jax.jit(make_rx_chain(M=M, Ntaps=Ntaps, os=os_,
                                    methods=("cma", "sbd"), mu=1e-3,
                                    bps_angles=32, bps_N=bps_N,
                                    TrSyms=2 ** 14, block_size=128))
        outs = []
        nchunks = Nsym // chunk_sym
        for c in range(nchunks):
            seg = jax.lax.dynamic_slice(
                Ep, (0, c * chunk_sym * os_),
                (2, chunk_sym * os_ + 2 * halo + 16))
            o = fwd(seg)
            outs.append(np.asarray(o[:, halo_sym:halo_sym + chunk_sym]))
        out = np.concatenate(outs, axis=-1)
        assert out.shape == (2, Nsym)
        ref = np.asarray(sig.symbols)
        const = np.unique(np.asarray(sig.coded_symbols))
        # Each blind dispatch retrains from identity taps, so each chunk
        # carries an INHERENT independent pi/2 ambiguity per mode (the
        # reference's blind receiver too — downstream differential coding
        # or the pilot chain resolves it; docs/MIGRATION.md). The delay
        # and pairing, however, must agree across chunks (identity centre
        # -tap init converges to the same group delay), and every chunk
        # must be internally clean under ONE fixed alignment — a seam
        # error (shifted window arithmetic) shows as ~25-94% SER.
        aligns, sers = [], []
        for c in range(nchunks):
            sl = slice(max(c * chunk_sym, 64),
                       min((c + 1) * chunk_sym, Nsym - 64))
            a = _find_alignment(out[:, sl], ref[:, sl], const)
            s = _ser_aligned(out[:, sl], ref[:, sl], const, a,
                             slice(16, -16))
            aligns.append(a)
            sers.append(s)
            assert s < 5e-3, "chunk %d SER %.2e (seam error?)" % (c, s)
        perms = {tuple(a[0]) for a in aligns}
        offsets = {tuple(a[1]) for a in aligns}
        assert len(perms) == 1, "pol pairing flipped across chunks: %s" % perms
        assert len(offsets) == 1, \
            "group delay shifted across chunks: %s" % offsets


class TestLongCapturePilot:
    def test_chunked_pilot_tracking_carry(self):
        """>=2^22 payload symbols of SignalWithPilots frames demodulated in
        4 dispatches: the first runs the full chain (sync + training), the
        rest ride the ``tracking`` entry with carried taps/shift/mode_order
        — per-chunk BER-checked against the TX bits."""
        M, F, P, R = 64, 2 ** 16, 1024, 32
        n_per, ndisp = 17, 4                   # 68 frames >= 2^22 payload
        NF = n_per * ndisp + 1
        sig = qt.SignalWithPilots(M, F, P, R, nframes=NF, nmodes=2,
                                  fb=24e9, seed=7)
        s2 = sig.resample(2 * sig.fb, beta=0.1, renormalise=True)
        s2 = impairments.simulate_transmission(
            s2, snr=28, lwdth=10e3, dgd=15e-12, theta=np.pi / 4.7,
            roll_frame_sync=True, key=jr.PRNGKey(9))
        E = jnp.asarray(s2.samples)

        fwd = make_pilot_rx_chain(
            np.asarray(sig.pilot_seq), np.asarray(sig.ph_pilots),
            F, R, os=2, M=M, nmodes=2, Ntaps=45, mu=(1e-3, 1e-3),
            Niter=30, cpe_avg=3, frames=tuple(range(n_per)),
            return_phase=False, block_size=128)
        jfwd = jax.jit(fwd)
        jtrk = jax.jit(fwd.tracking)

        ref_payload = np.asarray(sig.get_data(frames=[0]).samples)
        n_data = ref_payload.shape[-1]

        data0, info = jfwd(E)
        taps, shift, morder = info["taps"], info["shift"], info["mode_order"]
        chunks = [np.asarray(data0)]
        for d in range(1, ndisp):
            dat, _ = jtrk(E, taps, shift, mode_order=morder,
                          _frame_base=d * n_per * F * 2)
            chunks.append(np.asarray(dat))

        const = np.unique(np.asarray(sig.coded_symbols))
        for d, dat in enumerate(chunks):
            assert dat.shape == (2, n_per * n_data)
            for k in (0, n_per - 1):          # first + last frame per chunk
                fr = d * n_per + k
                got = dat[:, k * n_data:(k + 1) * n_data]
                want = np.asarray(sig.get_data(frames=[fr]).samples)
                # pilot chain output is frame-aligned and CPE-locked: no
                # offset/rotation search needed beyond the identity
                ser = float(np.mean([
                    np.mean(_dec_idx(got[m], const)
                            != _dec_idx(want[m], const))
                    for m in range(2)]))
                assert ser < 1e-2, \
                    "dispatch %d frame %d SER %.2e" % (d, fr, ser)

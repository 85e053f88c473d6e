"""Fused single-dispatch pilot RX chain (ops/pilot_chain.py).

Functional recovery through the whole jitted receiver — frame sync, pilot
equalisation, frame filtering, pilot CPE — against the reference pilot
tolerances (reference test/test_pilot_signal.py:103-118: SER < 1e-4 /
BER < 1e-5 at high SNR; here the frames are shorter so the gates are scaled
to the ~1e4-symbol payloads).
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import jax.random as jr

import qampy_tpu as qt
from qampy_tpu.ops.pilot_chain import make_pilot_rx_chain

FRAME = 2 ** 14
SEQ = 512
INS = 32


def _make_sig(seed=7, **imp):
    sig = qt.SignalWithPilots(64, FRAME, SEQ, INS, nframes=3, nmodes=2,
                              fb=24e9, seed=seed)
    s2 = sig.resample(2 * sig.fb, beta=0.1, renormalise=True)
    if imp:
        s2 = qt.impairments.simulate_transmission(s2, key=jr.PRNGKey(11), **imp)
    return sig, s2


def _run(sig, s2, cut=5000, **kwargs):
    # 17 taps like the reference's pilot tests (test_pilot_signal.py:85,94):
    # the short 512-symbol pilot sequence cannot train 45 taps cleanly
    kw = dict(os=2, M=64, nmodes=2, Ntaps=17, Niter=30, cpe_avg=3)
    kw.update(kwargs)
    fwd = make_pilot_rx_chain(np.asarray(sig.pilot_seq),
                              np.asarray(sig.ph_pilots),
                              sig.frame_len, sig.pilot_ins_rat, **kw)
    data, info = jax.jit(fwd)(jnp.asarray(s2.samples[:, cut:]))
    out = sig.get_data().replace(samples=jnp.asarray(np.asarray(data)))
    return out, info


class TestFusedPilotChain:
    def test_baseline_pmd_phase_noise(self):
        sig, s2 = _make_sig(snr=30, dgd=20e-12, theta=np.pi / 4.3, lwdth=20e3)
        out, info = _run(sig, s2)
        ser = np.asarray(out.cal_ser(synced=True))
        assert float(info["sync_corr"]) > 120
        assert np.all(ser < 5e-4), ser

    def test_modal_delay_distinct_shifts(self):
        sig, s2 = _make_sig(snr=30, dgd=20e-12, theta=np.pi / 4.3,
                            lwdth=20e3, modal_delay=[0, 3333])
        out, info = _run(sig, s2)
        ser = np.asarray(out.cal_ser(synced=True))
        shift = np.asarray(info["shift"])
        assert shift[0] != shift[1]
        assert np.all(ser < 5e-4), ser

    def test_mode_swap(self):
        sig, s2 = _make_sig(snr=30)
        s3 = s2.replace(samples=s2.samples[::-1])
        out, info = _run(sig, s3)
        assert list(np.asarray(info["mode_order"])) == [1, 0]
        ser = np.asarray(out.cal_ser(synced=True))
        assert np.all(ser < 5e-4), ser

    def test_freq_offset_foe_comp(self):
        sig, s2 = _make_sig(snr=30, freq_off=100e3)
        out, info = _run(sig, s2, foe_comp=True)
        ser = np.asarray(out.cal_ser(synced=True))
        assert np.all(ser < 5e-4), ser

    def test_data_aided_second_stage(self):
        sig, s2 = _make_sig(snr=30, dgd=20e-12, theta=np.pi / 4.3, lwdth=20e3)
        out, info = _run(sig, s2, methods=("cma", "sbd_data"))
        ser = np.asarray(out.cal_ser(synced=True))
        assert np.all(ser < 5e-4), ser

    def test_matches_granular_chain(self):
        """Fused chain vs the step-by-step API on the same capture."""
        sig, s2 = _make_sig(snr=30, dgd=20e-12, theta=np.pi / 4.3, lwdth=20e3)
        out, info = _run(sig, s2)
        s4 = s2[:, 5000:]
        s4.sync2frame(Ntaps=17)
        assert np.array_equal(np.sort(np.asarray(s4.shiftfctrs)),
                              np.sort(np.asarray(info["shift"])))
        wxy, eq_sig = qt.equalisation.pilot_equaliser(
            s4, (1e-3, 1e-3), 17, apply=True, foe_comp=False)
        d, _ = qt.phaserec.pilot_cpe(eq_sig, N=3, nframes=1)
        ser_gran = np.asarray(d.cal_ser())
        ser_fused = np.asarray(out.cal_ser(synced=True))
        assert np.all(ser_fused < 5e-4) and np.all(ser_gran < 5e-4)

    def test_multiframe(self):
        """Train once, demodulate two frames in the same dispatch
        (reference pilot_equaliser_nframes, qampy/equalisation.py:340-397)."""
        sig, s2 = _make_sig(snr=30, dgd=20e-12, theta=np.pi / 4.3,
                            lwdth=20e3, roll_frame_sync=True)
        out, info = _run(sig, s2, cut=0, frames=(0, 1))
        ndata = np.count_nonzero(np.asarray(sig.idx_pil) == 0)
        assert out.samples.shape == (2, 2 * ndata)
        ser = np.asarray(out.cal_ser(synced=True))
        assert np.all(ser < 1e-3), ser

    def test_span_mode_matches_scan(self):
        """frames_mode="span" (filter hoisted out of the frame loop, CPE
        frame-batched) must agree with the per-frame scan to float
        tolerance (the hoisted filter sums in a different lowering)."""
        sig = qt.SignalWithPilots(64, FRAME, SEQ, INS, nframes=6, nmodes=2,
                                  fb=24e9, seed=9)
        s2 = sig.resample(2 * sig.fb, beta=0.1, renormalise=True)
        s2 = qt.impairments.simulate_transmission(
            s2, snr=30, dgd=20e-12, theta=np.pi / 4.3, lwdth=20e3,
            roll_frame_sync=True, key=jr.PRNGKey(11))
        kw = dict(os=2, M=64, nmodes=2, Ntaps=17, Niter=30, cpe_avg=3,
                  frames=(0, 1, 2, 3))
        args = (np.asarray(sig.pilot_seq), np.asarray(sig.ph_pilots),
                sig.frame_len, sig.pilot_ins_rat)
        E = jnp.asarray(s2.samples)
        d0, i0 = jax.jit(make_pilot_rx_chain(*args, **kw))(E)
        d1, i1 = jax.jit(make_pilot_rx_chain(*args, frames_mode="span",
                                             **kw))(E)
        assert d1.shape == d0.shape
        np.testing.assert_allclose(np.asarray(jnp.abs(d0 - d1)), 0,
                                   atol=1e-4)
        np.testing.assert_allclose(np.asarray(i0["phase"]),
                                   np.asarray(i1["phase"]), atol=1e-4)

    def test_frame_parallel_mesh(self):
        """Frame-data-parallel demodulation over the 8-device mesh:
        sync/training replicated, each device demodulates its own frames
        (parallel/sharded.make_sharded_pilot_rx)."""
        import jax
        from qampy_tpu.parallel import make_mesh, sharded
        if len(jax.devices()) < 8:
            pytest.skip("needs the 8-device virtual mesh")
        sig = qt.SignalWithPilots(64, FRAME, SEQ, INS, nframes=10, nmodes=2,
                                  fb=24e9, seed=7)
        s2 = sig.resample(2 * sig.fb, beta=0.1, renormalise=True)
        s2 = qt.impairments.simulate_transmission(
            s2, snr=30, dgd=20e-12, theta=np.pi / 4.3, lwdth=20e3,
            roll_frame_sync=True, key=jr.PRNGKey(11))
        mesh = make_mesh(8)
        chain = sharded.make_sharded_pilot_rx(
            mesh, np.asarray(sig.pilot_seq), np.asarray(sig.ph_pilots),
            sig.frame_len, sig.pilot_ins_rat, frames_per_device=1,
            os=2, M=64, nmodes=2, Ntaps=17, Niter=30, cpe_avg=3)
        data, shift, corr = chain(jnp.asarray(s2.samples))
        assert np.asarray(corr).shape == (8,)
        out = sig.get_data().replace(samples=jnp.asarray(np.asarray(data)))
        ser = np.asarray(out.cal_ser(synced=True))
        assert np.all(ser < 1e-3), ser

    def test_frames_pack_matches(self):
        """frames_unroll=2 (two frame bodies per scan step) must match the
        plain per-frame scan."""
        sig = qt.SignalWithPilots(64, FRAME, SEQ, INS, nframes=8, nmodes=2,
                                  fb=24e9, seed=3)
        s2 = sig.resample(2 * sig.fb, beta=0.1, renormalise=True)
        s2 = qt.impairments.simulate_transmission(
            s2, snr=30, dgd=20e-12, theta=np.pi / 4.7, lwdth=20e3,
            roll_frame_sync=True, key=jr.PRNGKey(5))
        E = jnp.asarray(s2.samples)
        kw = dict(os=2, M=64, nmodes=2, Ntaps=17, Niter=30, cpe_avg=3,
                  frames=(0, 1, 2, 3), return_phase=False)
        args = (np.asarray(sig.pilot_seq), np.asarray(sig.ph_pilots),
                sig.frame_len, sig.pilot_ins_rat)
        d0, _ = jax.jit(make_pilot_rx_chain(*args, **kw))(E)
        d2, _ = jax.jit(make_pilot_rx_chain(*args, frames_unroll=2, **kw))(E)
        np.testing.assert_allclose(np.abs(np.asarray(d2 - d0)), 0,
                                   atol=1e-5)

    def test_ls_trainer_recovers(self):
        """eq_trainer='ls' (closed-form data-aided equalisation: one Gram
        matmul + real-block solve instead of Niter*TrS/S LMS block steps)
        must recover at least as well as the LMS path on the same
        channel; measured CPU gate: SER exactly 0 where LMS reads
        ~3e-4."""
        sig = qt.SignalWithPilots(64, FRAME, SEQ, INS, nframes=6, nmodes=2,
                                  fb=24e9, seed=3)
        s2 = sig.resample(2 * sig.fb, beta=0.1, renormalise=True)
        s2 = qt.impairments.simulate_transmission(
            s2, snr=30, dgd=20e-12, theta=np.pi / 4.7, lwdth=20e3,
            roll_frame_sync=True, key=jr.PRNGKey(5))
        E = jnp.asarray(s2.samples)
        fwd = make_pilot_rx_chain(
            np.asarray(sig.pilot_seq), np.asarray(sig.ph_pilots),
            sig.frame_len, sig.pilot_ins_rat, os=2, M=64, nmodes=2,
            Ntaps=17, Niter=30, cpe_avg=3, frames=(0, 1, 2),
            eq_trainer="ls")
        assert fwd.backend_info["eq_trainer"] == "ls"
        data, info = jax.jit(fwd)(E)
        out = sig.get_data(frames=[0, 1, 2]).replace(
            samples=jnp.asarray(np.asarray(data)))
        ser = np.asarray(out.cal_ser(synced=True))
        assert np.all(ser < 1e-4), ser
        # tracking round-trip: the LS taps feed the warm-start entry
        data_trk, _ = fwd.tracking(E, info["taps"], info["shift"],
                                   mode_order=info["mode_order"])
        np.testing.assert_allclose(np.abs(np.asarray(data_trk)
                                          - np.asarray(data)), 0,
                                   atol=1e-5)

    def test_sharded_prefix_ls(self):
        """shard_prefix + eq_trainer='ls': the distributed cold-start with
        the closed-form trainer matches its own replicated chain."""
        import jax as _jax
        from qampy_tpu.parallel import make_mesh, sharded
        if len(_jax.devices()) < 8:
            pytest.skip("needs the 8-device virtual mesh")
        sig = qt.SignalWithPilots(64, FRAME, SEQ, INS, nframes=10, nmodes=2,
                                  fb=24e9, seed=7)
        s2 = sig.resample(2 * sig.fb, beta=0.1, renormalise=True)
        s2 = qt.impairments.simulate_transmission(
            s2, snr=30, dgd=20e-12, theta=np.pi / 4.3, lwdth=20e3,
            roll_frame_sync=True, key=jr.PRNGKey(11))
        mesh = make_mesh(8)
        kw = dict(os=2, M=64, nmodes=2, Ntaps=17, Niter=30, cpe_avg=3,
                  eq_trainer="ls")
        rep = sharded.make_sharded_pilot_rx(
            mesh, np.asarray(sig.pilot_seq), np.asarray(sig.ph_pilots),
            sig.frame_len, sig.pilot_ins_rat, frames_per_device=1, **kw)
        shp = sharded.make_sharded_pilot_rx(
            mesh, np.asarray(sig.pilot_seq), np.asarray(sig.ph_pilots),
            sig.frame_len, sig.pilot_ins_rat, frames_per_device=1,
            shard_prefix=True, **kw)
        E = jnp.asarray(s2.samples)
        d0, _, _ = rep(E)
        d1, _, _ = shp(E)
        # vmapped vs per-mode LS solve: LU reduction-order float noise
        np.testing.assert_allclose(np.asarray(d1), np.asarray(d0),
                                   atol=2e-4)
        out = sig.get_data().replace(samples=jnp.asarray(np.asarray(d1)))
        ser = np.asarray(out.cal_ser(synced=True))
        assert np.all(ser < 1e-4), ser

    def test_sharded_prefix_matches_replicated(self):
        """shard_prefix=True distributes the cold-start prefix (window
        search chunks per device, per-mode alignment + pilot trainings on
        device groups, tiny all_gathers) — the acquired state and the
        demodulated frames must match the replicated-prefix sharded chain
        to float reduction-order ulps (same trainings, same selection
        arithmetic, only the execution placement differs)."""
        import jax
        from qampy_tpu.parallel import make_mesh, sharded
        if len(jax.devices()) < 8:
            pytest.skip("needs the 8-device virtual mesh")
        sig = qt.SignalWithPilots(64, FRAME, SEQ, INS, nframes=10, nmodes=2,
                                  fb=24e9, seed=7)
        s2 = sig.resample(2 * sig.fb, beta=0.1, renormalise=True)
        s2 = qt.impairments.simulate_transmission(
            s2, snr=30, dgd=20e-12, theta=np.pi / 4.3, lwdth=20e3,
            roll_frame_sync=True, key=jr.PRNGKey(11))
        mesh = make_mesh(8)
        # eq_trainer pinned to lms on BOTH sides: shard_prefix=True
        # otherwise defaults to the LS trainer (different taps)
        kw = dict(os=2, M=64, nmodes=2, Ntaps=17, Niter=30, cpe_avg=3,
                  eq_trainer="lms")
        rep = sharded.make_sharded_pilot_rx(
            mesh, np.asarray(sig.pilot_seq), np.asarray(sig.ph_pilots),
            sig.frame_len, sig.pilot_ins_rat, frames_per_device=1, **kw)
        shp = sharded.make_sharded_pilot_rx(
            mesh, np.asarray(sig.pilot_seq), np.asarray(sig.ph_pilots),
            sig.frame_len, sig.pilot_ins_rat, frames_per_device=1,
            shard_prefix=True, **kw)
        assert shp.backend_info["shard_prefix"]
        E = jnp.asarray(s2.samples)
        d0, sh0, c0 = rep(E)
        d1, sh1, c1 = shp(E)
        np.testing.assert_array_equal(np.asarray(sh1), np.asarray(sh0))
        np.testing.assert_allclose(np.asarray(c1), np.asarray(c0),
                                   rtol=1e-6)
        np.testing.assert_allclose(np.asarray(d1), np.asarray(d0),
                                   atol=1e-5)
        out = sig.get_data().replace(samples=jnp.asarray(np.asarray(d1)))
        ser = np.asarray(out.cal_ser(synced=True))
        assert np.all(ser < 1e-3), ser

    def test_tracking_warm_start(self):
        """forward.tracking (taps/shift from a previous dispatch, sync and
        training skipped) must reproduce the full chain bit-exactly."""
        sig = qt.SignalWithPilots(64, FRAME, SEQ, INS, nframes=6, nmodes=2,
                                  fb=24e9, seed=3)
        s2 = sig.resample(2 * sig.fb, beta=0.1, renormalise=True)
        s2 = qt.impairments.simulate_transmission(
            s2, snr=30, dgd=20e-12, theta=np.pi / 4.7, lwdth=20e3,
            roll_frame_sync=True, key=jr.PRNGKey(5))
        E = jnp.asarray(s2.samples)
        fwd = make_pilot_rx_chain(np.asarray(sig.pilot_seq),
                                  np.asarray(sig.ph_pilots),
                                  sig.frame_len, sig.pilot_ins_rat,
                                  os=2, M=64, nmodes=2, Ntaps=17, Niter=30,
                                  cpe_avg=3, frames=(0, 1, 2, 3))
        d0, i0 = jax.jit(fwd)(E)
        d1, i1 = jax.jit(fwd.tracking)(E, i0["taps"], i0["shift"],
                                       i0["mode_order"])
        assert bool(jnp.all(d0 == d1))
        assert np.isinf(float(i1["sync_corr"]))  # marks sync-not-run

    def test_tracking_planes_matches_complex(self):
        """forward.tracking_planes (planes in/out, mode_order folded into
        the taps' input axis instead of permuting the capture) must
        reproduce forward.tracking bit-exactly — including with a mode
        swap, which exercises the taps-permute fold."""
        sig = qt.SignalWithPilots(64, FRAME, SEQ, INS, nframes=6, nmodes=2,
                                  fb=24e9, seed=3)
        s2 = sig.resample(2 * sig.fb, beta=0.1, renormalise=True)
        s2 = qt.impairments.simulate_transmission(
            s2, snr=30, dgd=20e-12, theta=np.pi / 4.7, lwdth=20e3,
            roll_frame_sync=True, key=jr.PRNGKey(5))
        E = jnp.asarray(np.asarray(s2.samples)[::-1])   # swap pols
        fwd = make_pilot_rx_chain(np.asarray(sig.pilot_seq),
                                  np.asarray(sig.ph_pilots),
                                  sig.frame_len, sig.pilot_ins_rat,
                                  os=2, M=64, nmodes=2, Ntaps=17, Niter=30,
                                  cpe_avg=3, frames=(0, 1, 2))
        d0, i0 = jax.jit(fwd)(E)
        assert list(np.asarray(i0["mode_order"])) == [1, 0]
        d1, i1 = jax.jit(fwd.tracking)(E, i0["taps"], i0["shift"],
                                       i0["mode_order"])
        (dr, di), i2 = jax.jit(fwd.tracking_planes)(
            E.real, E.imag, i0["taps"], i0["shift"], i0["mode_order"])
        # the taps-permute fold reorders the contraction's input axis, so
        # float summation order differs: tight-tolerance, not bitwise
        assert np.allclose(np.asarray(dr + 1j * di), np.asarray(d1),
                           atol=2e-5), np.abs(np.asarray(dr + 1j * di)
                                              - np.asarray(d1)).max()
        assert bool(jnp.all(i2["taps"] == i0["taps"]))  # re-feedable verbatim
        assert np.isinf(float(i2["sync_corr"]))
        # the planes-native FULL chain shares the demod path -> bit-equal
        (fr, fi), i3 = jax.jit(fwd.planes)(E.real, E.imag)
        assert bool(jnp.all(fr + 1j * fi == d0))
        assert bool(jnp.all(i3["taps"] == i0["taps"]))

    def test_backend_info(self):
        sig, _ = _make_sig()
        fwd = make_pilot_rx_chain(np.asarray(sig.pilot_seq),
                                  np.asarray(sig.ph_pilots),
                                  sig.frame_len, sig.pilot_ins_rat)
        assert "trainer" in fwd.backend_info
        assert fwd.backend_info["methods"] == ("cma", "cma")

    def test_ps_shaped_payload(self):
        """Heavily MB-shaped payload (nu=1.5, H=5.56 bits — beyond the
        blind chain's lock range, docs/PERFORMANCE.md) demodulates
        exactly through the pilot chain: data-aided training and the
        alphabet-free payload path are shaping-independent, matching the
        reference's PS workflow ("Geometric shaping ... pilot_based
        centering" notebook)."""
        from qampy_tpu import theory
        from qampy_tpu.theory import cal_symbols_qam, cal_scaling_factor_qam
        base = (cal_symbols_qam(64)
                / np.sqrt(cal_scaling_factor_qam(64))).astype(np.complex64)
        lv, pl = theory.cal_ps_probablts(base, 1.5)
        probs = (pl[np.searchsorted(lv, base.real)]
                 * pl[np.searchsorted(lv, base.imag)])
        probs /= probs.sum()
        coded = (base / np.sqrt(np.sum(probs * np.abs(base) ** 2))
                 ).astype(np.complex64)
        rng = np.random.default_rng(5)
        npl = (FRAME - SEQ) * (INS - 1) // INS
        pay = coded[rng.choice(64, size=(2, npl), p=probs)]
        pays = qt.SymbolOnlySignal.from_symbol_array(
            pay, coded_symbols=coded, fb=24e9)
        sig = qt.SignalWithPilots.from_symbol_array(pays, FRAME, SEQ, INS,
                                                    nframes=4)
        s2 = sig.resample(2 * sig.fb, beta=0.1, renormalise=True)
        s2 = qt.impairments.simulate_transmission(
            s2, snr=30, dgd=20e-12, theta=np.pi / 4.3, lwdth=20e3,
            roll_frame_sync=True, key=jr.PRNGKey(9))
        fwd = make_pilot_rx_chain(np.asarray(sig.pilot_seq),
                                  np.asarray(sig.ph_pilots),
                                  sig.frame_len, sig.pilot_ins_rat,
                                  os=2, M=64, nmodes=2, Ntaps=17, Niter=30,
                                  cpe_avg=3, frames=(0, 1))
        d, info = jax.jit(fwd)(jnp.asarray(s2.samples))
        out = np.asarray(d)
        ref = np.asarray(sig.get_data(frames=[0, 1]).samples)
        dec = np.argmin(np.abs(out[..., None] - coded[None, None, :]), -1)
        rdec = np.argmin(np.abs(ref[..., None] - coded[None, None, :]), -1)
        ser = np.mean(dec != rdec, axis=-1)
        # demonstrative gate: the blind chain measures SER ~1 here (total
        # loss of lock); the pilot chain sits at/near zero errors
        assert np.all(ser < 1e-3), ser

    def test_gen_256pt_payload(self):
        """A 256-point NON-GRID (radially warped) payload through the
        pilot chain: the data-aided/alphabet-free path serves any-M
        alphabets the blind chain cannot lock onto (blind 256-ary is
        outside even the reference's demonstrated envelope — its
        higher-order notebook stops at 64-QAM). Warping costs ~2.3 dB of
        minimum distance, hence the 40 dB operating point."""
        from qampy_tpu.theory import warped_qam
        const = warped_qam(256)
        rng = np.random.default_rng(6)
        npl = (FRAME - SEQ) * (INS - 1) // INS
        pay = const[rng.integers(0, 256, size=(2, npl))]
        pays = qt.SymbolOnlySignal.from_symbol_array(
            pay, coded_symbols=const, fb=24e9)
        sig = qt.SignalWithPilots.from_symbol_array(pays, FRAME, SEQ, INS,
                                                    nframes=4)
        s2 = sig.resample(2 * sig.fb, beta=0.1, renormalise=True)
        s2 = qt.impairments.simulate_transmission(
            s2, snr=40, dgd=20e-12, theta=np.pi / 4.3, lwdth=20e3,
            roll_frame_sync=True, key=jr.PRNGKey(9))
        fwd = make_pilot_rx_chain(np.asarray(sig.pilot_seq),
                                  np.asarray(sig.ph_pilots),
                                  sig.frame_len, sig.pilot_ins_rat,
                                  os=2, M=256, nmodes=2, Ntaps=17,
                                  Niter=30, cpe_avg=3, frames=(0, 1))
        d, info = jax.jit(fwd)(jnp.asarray(s2.samples))
        out = np.asarray(d)
        ref = np.asarray(sig.get_data(frames=[0, 1]).samples)
        dec = np.argmin(np.abs(out[..., None] - const[None, None, :]), -1)
        rdec = np.argmin(np.abs(ref[..., None] - const[None, None, :]), -1)
        ser = np.mean(dec != rdec, axis=-1)
        assert np.all(ser < 1e-2), ser

    def test_span_mode_rejects_noncontiguous_frames(self):
        """An unsatisfiable frames_mode='span' request must raise instead
        of silently falling back to the scan lowering (ADVICE r2)."""
        sig, s2 = _make_sig()
        args = (np.asarray(sig.pilot_seq), np.asarray(sig.ph_pilots),
                sig.frame_len, sig.pilot_ins_rat)
        kw = dict(os=2, M=64, nmodes=2, Ntaps=17, Niter=30)
        fwd = make_pilot_rx_chain(*args, frames=(0, 2, 3, 5),
                                  frames_mode="span", **kw)
        with pytest.raises(ValueError, match="contiguous"):
            jax.jit(fwd)(jnp.asarray(s2.samples))
        # too few frames is equally unsatisfiable
        fwd2 = make_pilot_rx_chain(*args, frames=(0, 1),
                                   frames_mode="span", **kw)
        with pytest.raises(ValueError, match="contiguous"):
            jax.jit(fwd2)(jnp.asarray(s2.samples))

    def test_tracking_foe_contract(self):
        """forward_tracking: foe= on a foe_comp=False chain raises; a
        foe_comp=True chain without foe= warns (frozen taps were trained
        on FOE-compensated segments) (ADVICE r2)."""
        sig, s2 = _make_sig()
        args = (np.asarray(sig.pilot_seq), np.asarray(sig.ph_pilots),
                sig.frame_len, sig.pilot_ins_rat)
        kw = dict(os=2, M=64, nmodes=2, Ntaps=17, Niter=30)
        E = jnp.asarray(s2.samples)
        w = jnp.zeros((2, 2, 17), jnp.complex64)
        sh = jnp.zeros((2,), jnp.int32)
        fwd = make_pilot_rx_chain(*args, foe_comp=False, **kw)
        with pytest.raises(ValueError, match="foe_comp=False"):
            fwd.tracking(E, w, sh, foe=0.01)
        fwd_foe = make_pilot_rx_chain(*args, foe_comp=True, **kw)
        with pytest.warns(UserWarning, match="FOE-compensated"):
            fwd_foe.tracking(E, w, sh)
        # with foe= supplied: no warning
        import warnings as _w
        with _w.catch_warnings():
            _w.simplefilter("error")
            d, info = fwd_foe.tracking(E, w, sh, foe=0.0)

    def test_tracking_foe_roundtrip(self):
        """tracking with the previous dispatch's info['foe_pil'] matches
        the full foe_comp chain bit-exactly on the same taps."""
        sig = qt.SignalWithPilots(64, FRAME, SEQ, INS, nframes=6, nmodes=2,
                                  fb=24e9, seed=3)
        s2 = sig.resample(2 * sig.fb, beta=0.1, renormalise=True)
        s2 = qt.impairments.simulate_transmission(
            s2, snr=30, lwdth=20e3, freq_off=20e6,
            roll_frame_sync=True, key=jr.PRNGKey(5))
        E = jnp.asarray(s2.samples)
        fwd = make_pilot_rx_chain(np.asarray(sig.pilot_seq),
                                  np.asarray(sig.ph_pilots),
                                  sig.frame_len, sig.pilot_ins_rat,
                                  os=2, M=64, nmodes=2, Ntaps=17, Niter=30,
                                  cpe_avg=3, frames=(0, 1, 2), foe_comp=True)
        d0, i0 = jax.jit(fwd)(E)
        d1, i1 = jax.jit(fwd.tracking)(E, i0["taps"], i0["shift"],
                                       i0["mode_order"], foe=i0["foe_pil"])
        assert bool(jnp.all(d0 == d1))


class TestPallasFrameFilter:
    def test_vmap_frames_match_scan(self):
        """frames_mode="vmap" (every frame's filter batched into one
        contraction) gives the scan's payload and frame geometry, and
        both pass the SER gate."""
        sig = qt.SignalWithPilots(64, FRAME, SEQ, INS, nframes=5, nmodes=2,
                                  fb=24e9, seed=13)
        s2 = sig.resample(2 * sig.fb, beta=0.1, renormalise=True)
        s2 = qt.impairments.simulate_transmission(
            s2, snr=30, dgd=15e-12, theta=np.pi / 4.4, lwdth=10e3,
            roll_frame_sync=True, key=jr.PRNGKey(3))
        out_s, info_s = _run(sig, s2, cut=0, frames=(0, 1, 2))
        out_v, info_v = _run(sig, s2, cut=0, frames=(0, 1, 2),
                             frames_mode="vmap")
        np.testing.assert_array_equal(np.asarray(info_s["shift"]),
                                      np.asarray(info_v["shift"]))
        d = np.abs(np.asarray(out_v.samples) - np.asarray(out_s.samples))
        assert float(np.max(d)) < 1e-4, float(np.max(d))
        ser = np.asarray(out_v.cal_ser(synced=True))
        assert np.all(ser < 5e-4), ser

    @pytest.mark.parametrize("mode", ["span_planes", "auto", "pack"])
    def test_span_planes_matches_scan(self, mode):
        """Frame-loop lowerings that no longer exist are refused when the
        chain is built."""
        sig, _ = _make_sig()
        with pytest.raises(ValueError, match="unknown frames_mode"):
            make_pilot_rx_chain(np.asarray(sig.pilot_seq),
                                np.asarray(sig.ph_pilots), sig.frame_len,
                                sig.pilot_ins_rat, frames_mode=mode)

    def test_kernel_interp_matches_xla_interp(self):
        """return_phase=False (the serving config: no phase trace kept)
        must give the same payload as the chain that returns the trace."""
        sig, s2 = _make_sig(snr=30, dgd=15e-12, theta=np.pi / 4.5,
                            lwdth=10e3)
        out_a, _ = _run(sig, s2)
        out_b, _ = _run(sig, s2, return_phase=False)
        d = np.abs(np.asarray(out_a.samples) - np.asarray(out_b.samples))
        assert float(np.max(d)) < 1e-4, float(np.max(d))
        ser = np.asarray(out_b.cal_ser(synced=True))
        assert np.all(ser < 5e-4), ser

    def test_frame_parallel_tracking(self):
        """Sharded steady-state serving: the tracking entry of the
        frame-parallel mesh receiver demodulates each device's frames
        with state from a previous full dispatch — zero replicated
        prefix, output matches the full sharded chain's frames."""
        import jax
        from qampy_tpu.parallel import make_mesh, sharded
        if len(jax.devices()) < 8:
            pytest.skip("needs the 8-device virtual mesh")
        sig = qt.SignalWithPilots(64, FRAME, SEQ, INS, nframes=10, nmodes=2,
                                  fb=24e9, seed=7)
        s2 = sig.resample(2 * sig.fb, beta=0.1, renormalise=True)
        s2 = qt.impairments.simulate_transmission(
            s2, snr=30, dgd=20e-12, theta=np.pi / 4.3, lwdth=20e3,
            roll_frame_sync=True, key=jr.PRNGKey(11))
        mesh = make_mesh(8)
        chain = sharded.make_sharded_pilot_rx(
            mesh, np.asarray(sig.pilot_seq), np.asarray(sig.ph_pilots),
            sig.frame_len, sig.pilot_ins_rat, frames_per_device=1,
            os=2, M=64, nmodes=2, Ntaps=17, Niter=30, cpe_avg=3)
        # acquire state with the single-chip chain (same fwd semantics)
        from qampy_tpu.ops.pilot_chain import make_pilot_rx_chain
        fwd = make_pilot_rx_chain(
            np.asarray(sig.pilot_seq), np.asarray(sig.ph_pilots),
            sig.frame_len, sig.pilot_ins_rat, os=2, M=64, nmodes=2,
            Ntaps=17, Niter=30, cpe_avg=3)
        E = jnp.asarray(s2.samples)
        _, info = jax.jit(fwd)(E)
        data_full, _, _ = chain(E)
        data_trk = chain.tracking(E, info["taps"], info["shift"],
                                  info["mode_order"])
        np.testing.assert_allclose(np.abs(np.asarray(data_trk)
                                          - np.asarray(data_full)), 0,
                                   atol=1e-4)
        out = sig.get_data().replace(
            samples=jnp.asarray(np.asarray(data_trk)))
        ser = np.asarray(out.cal_ser(synced=True))
        assert np.all(ser < 1e-3), ser

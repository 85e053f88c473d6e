"""Fused single-dispatch pilot RX chain (the pilot-frame serving path).

``make_pilot_rx_chain`` builds one jittable ``forward(E) -> (data, info)``
that runs the reference's full pilot receiver — frame synchronisation,
two-stage data-aided pilot equalisation, tap-frozen frame filtering and
pilot-aided carrier phase estimation — as a SINGLE XLA program. Parity
workload: reference ``test/sim_pilot_txrx.py`` (run_pilot_receiver2) driving
``qampy/core/pilotbased_receiver.py:329-554`` and
``pilot_based_cpe_new`` (:258-327).

Re-design of each stage (vs the reference's host loops):

* frame sync (reference :329-434): the ~W candidate windows are trained in
  ONE vmapped block-LMS call (the windows dimension is a batch axis);
  the per-mode alignment is a single batched FFT cross-correlation over all
  ``nmodes x nmodes`` (output mode, tx mode) pairs, and the greedy mode
  assignment runs as traced argmax-with-mask arithmetic — no host round
  trips, the found shifts stay on device as traced integers feeding
  ``lax.dynamic_slice``.
* pilot equalisation (reference :454-554): the three trainings per mode
  (blind warm-up + two data/pilot passes) run on the block trainer
  (ops/equaliser.train_equaliser_block) instead of Niter*seq_len sequential
  steps — ~240 matmul steps instead of ~30k scalar recurrence steps;
  ``eq_trainer="ls"`` solves the same data-aided fit in closed form.
* frame filter: the windows-batched contraction
  (ops/equaliser.apply_filter_to_signal) over the frame at the traced shift.
* CPE (reference :258-327): phase-pilot gather, unwrap, cumsum moving
  average and linear interpolation — all fused elementwise/FFT-free XLA.

The granular API (ops/pilots.py) keeps the reference's step-by-step
orchestration for interactive use; this module is the production fast path
behind bench.py's pilot-chain number.
"""
from __future__ import annotations

from functools import partial

import numpy as np

__all__ = ["make_pilot_rx_chain"]


def _xcorr_batched(xf, y, n, nfft):
    """Full linear cross-correlation of a batch of references against y.

    ``xf = fft(x, nfft)`` is precomputed host-side for the (static)
    reference sequences; ``y`` is traced. Returns
    ``core/sync._xcorr_full(x_j, y) = fftconvolve(x_j, conj(y)[::-1])``
    for every reference row j in one batched FFT.
    """
    import jax.numpy as jnp
    Y = jnp.fft.fft(jnp.conj(y)[..., ::-1], nfft)
    return jnp.fft.ifft(xf * Y)[..., :n]


def make_pilot_rx_chain(pilot_seq, ph_pilots, frame_len, pilot_ins_rat,
                        os=2, M=64, nmodes=2, M_pilot=4,
                        sync_Ntaps=17, sync_mu=1e-3, sync_Niter=10,
                        Ntaps=45, mu=(1e-3, 1e-3), Niter=30,
                        methods=("cma", "cma"), foe_comp=False,
                        cpe_avg=3, cpe_pilot_rat=1, frames=(0,),
                        block_size=128, frames_mode="scan",
                        frames_unroll=1, return_phase=True,
                        eq_trainer="lms"):
    """Build a jittable ``forward(E) -> (data, info)`` pilot receiver.

    Parameters mirror the granular chain: ``pilot_seq`` (nmodes,
    pilot_seq_len) and ``ph_pilots`` (nmodes, nph) are the known TX pilots
    as host numpy complex arrays;
    ``frame_len``/``pilot_ins_rat`` the SignalWithPilots layout;
    ``sync_*`` the frame-search training (reference frame_sync defaults,
    signals.py sync2frame); ``Ntaps``/``mu``/``Niter``/``methods`` the
    two-stage pilot equaliser (reference equalize_pilot_sequence);
    ``cpe_avg``/``cpe_pilot_rat`` the pilot CPE; ``frames`` which frames of
    the capture to demodulate (sync + tap training run ONCE and the trained
    taps demodulate every requested frame — the steady-state serving
    pattern of reference ``pilot_equaliser_nframes``,
    qampy/equalisation.py:340-397). ``E`` is the complex (nmodes, L)
    capture at ``os`` samples/symbol with
    L >= (max(frames)+1)*frame_len*os + shift headroom.

    Returns ``(data, info)`` where ``data`` is the (nmodes,
    len(frames)*n_data) demodulated payload symbol sequence (pilots
    removed, frames concatenated) and ``info`` is a
    dict of real-valued diagnostics: ``shift`` (per-mode frame offsets in
    samples), ``sync_corr`` (the weakest pilot autocorrelation peak — frame
    sync is unreliable below ops.pilots.FRAME_SYNC_THRS), ``foe`` (per-mode
    coarse + pilot frequency-offset estimate, fractional units), ``phase``
    (the CPE trace over the frame; omitted when ``return_phase=False`` to
    save the per-frame trace write + final relayout), ``mode_order`` (the
    found mode permutation) and ``taps``. ``frames_mode`` lowers the frame
    loop as a ``"scan"`` (default), a ``"vmap"`` over frames, or a
    ``"span"`` (one filter pass over >2 contiguous frames);
    ``frames_unroll`` unrolls the frame scan body that many times per loop
    step (cross-frame fusion without the full-unroll compile blowup).
    ``forward.planes`` and ``forward.tracking_planes`` take and return
    float32 real/imag planes instead of complex arrays.
    """
    import jax
    import jax.numpy as jnp
    from jax import lax
    from qampy_tpu.ops import equaliser as eqops
    from qampy_tpu.signals import SignalWithPilots

    dtype = np.complex64
    pilot_seq = np.asarray(pilot_seq).astype(dtype)
    ph_pilots = np.asarray(ph_pilots).astype(dtype)
    nmodes = int(nmodes)
    seq_len = pilot_seq.shape[-1]
    frame_len = int(frame_len)
    os = int(os)
    assert pilot_seq.shape[0] == nmodes and ph_pilots.shape[0] == nmodes
    if methods[1] in eqops.DATA_AIDED or methods[0] in eqops.DATA_AIDED:
        assert methods[0] not in eqops.REAL_VALUED, \
            "fused pilot chain implements complex-valued methods"
    if frames_mode not in ("scan", "vmap", "span"):
        raise ValueError("unknown frames_mode %r" % (frames_mode,))

    # ---- static frame-sync geometry (reference :358-366) ------------------
    sw = seq_len * os                       # search window
    step = sw // 2                          # search_overlap = 2
    num_steps = frame_len * os // step + 1
    starts = np.arange(2, num_steps) * step          # candidate window starts
    W = starts.shape[0]
    TrS_sync = eqops._cal_training_symbol_len(os, sync_Ntaps, sw)
    sym_sync = eqops._reshape_symbols(None, "cma", M_pilot, dtype, nmodes)
    w0_sync = eqops._init_taps(sync_Ntaps, nmodes, nmodes, dtype)
    # alignment segment: 2 search windows around the winning start
    Ls = (2 * sw - sync_Ntaps) // os + 1     # symbols out of the aligner
    nxc = seq_len + Ls - 1
    nfft = int(2 ** np.ceil(np.log2(nxc)))
    # precomputed FFT of the pilot sequences (host constants)
    seq_f = np.fft.fft(pilot_seq, nfft, axis=-1)
    foe_fft = 2 ** 16

    # ---- static pilot-equaliser geometry (reference :454-554) -------------
    seg_len = seq_len * os + Ntaps - 1
    TrS_eq = eqops._cal_training_symbol_len(os, Ntaps, seg_len)
    sym_st1 = eqops._reshape_symbols(None, methods[0], M_pilot, dtype, 1)
    da = [m in eqops.DATA_AIDED for m in methods]
    w0_eq = eqops._init_taps(Ntaps, nmodes, nmodes, dtype)
    if (Ntaps - sync_Ntaps) % os != 0:
        raise ValueError("Taps for search and convergence improperly configured")
    tap_corr = (Ntaps - sync_Ntaps) // 2    # reference correct_shifts (:436-443)

    # ---- static CPE geometry (reference :258-327, phaserec.pilot_cpe) -----
    _, idx_dat, idx_pil = SignalWithPilots._cal_pilot_idx(
        frame_len, seq_len, pilot_ins_rat)
    ph_idx = np.nonzero(idx_pil)[0][seq_len:][::cpe_pilot_rat]
    pil_cpe = ph_pilots[:, ::cpe_pilot_rat][:, :ph_idx.shape[0]]
    if cpe_avg % 2 == 0:
        cpe_avg += 1
    i_adj = (cpe_avg - 1) // 2
    idx_avg = ph_idx[i_adj:-i_adj]
    # the phase pilots are UNIFORMLY spaced (seq_len + k*ins_rat, layout
    # spec _cal_pilot_idx): linear interpolation over a uniform grid is a
    # pure broadcast+reshape upsample — no searchsorted, no gathers
    cpe_dx = int(pilot_ins_rat) * int(cpe_pilot_rat)
    assert np.all(np.diff(idx_avg) == cpe_dx), "non-uniform pilot spacing"
    cpe_x0 = int(idx_avg[0])
    dat_idx = np.nonzero(idx_dat)[0]
    # with cpe_pilot_rat == 1 the frame tail is exact R-sample blocks
    # (pilot at offset 0, payload at 1..R-1): the pilot and payload
    # extractions are then pure reshapes+slices instead of 2k/62k-element
    # gathers
    nblk_cpe = (frame_len - seq_len) // int(pilot_ins_rat)
    blocked_cpe = (cpe_pilot_rat == 1
                   and (frame_len - seq_len) % int(pilot_ins_rat) == 0
                   and np.array_equal(
                       dat_idx, (seq_len + np.arange(nblk_cpe)[:, None]
                                 * pilot_ins_rat
                                 + np.arange(1, pilot_ins_rat)[None, :]
                                 ).reshape(-1)))

    S = int(block_size)

    def _train(E_seg, TrS, Niter_, mu_, w, syms, method):
        err, wx, _ = eqops.train_equaliser_block(
            E_seg, int(TrS), int(Niter_), os, float(mu_), w, syms, method,
            adaptive=True, block_size=S)
        return err, wx

    assert eq_trainer in ("lms", "ls"), eq_trainer

    def _ls_taps_mode(seg, ref):
        """Closed-form data-aided pilot equalisation for one output mode.

        The applied filter is a plain (conjugation-free) complex FIR
        (``out[k] = sum_{p,t} w[p,t] seg[p, k*os+t]``,
        ops/equaliser._apply_filter_windows), so the data-aided training
        the reference solves with Niter*seq_len LMS iterations
        (core/pilotbased_receiver.py:454-554) is an ORDINARY linear
        least-squares problem: w* = argmin ||X w - ref||^2 with
        X[k, (p,t)] = seg[p, k*os+t]. One Gram matmul (TrS x
        nmodes*Ntaps) + a real-block 2PK x 2PK solve replaces
        ~Niter*TrS/S dependent block steps — the pilot-training latency
        floor of the cold-start prefix. Both run in full float32
        (HIGHEST): a TF32 Gram matrix would carry ~1e-3 relative error
        into the normal equations. Tikhonov-regularised
        (lam ~ 1e-4 of the mean diagonal); phase/delay ambiguities are
        resolved by the fit itself (no blind warm-up stage needed).
        Opt-in via ``eq_trainer="ls"`` — BER-gate equivalence vs the LMS
        path is pinned by tests and the bench gate.
        """
        K = TrS_eq
        idx = jnp.arange(K)[:, None] * os + jnp.arange(Ntaps)[None, :]
        Xp = seg[:, idx]                        # (n, K, Ntaps) gather
        X = Xp.swapaxes(0, 1).reshape(K, nmodes * Ntaps)
        Xr, Xi = X.real, X.imag
        dr_, di_ = ref[:K].real, ref[:K].imag
        mm = partial(jnp.matmul, precision=lax.Precision.HIGHEST)
        S = mm(Xr.T, Xr) + mm(Xi.T, Xi)         # Re(X^H X), symmetric
        T_ = mm(Xr.T, Xi) - mm(Xi.T, Xr)        # Im(X^H X), antisymmetric
        Pn = nmodes * Ntaps
        lam = 1e-4 * jnp.trace(S) / Pn
        S = S + lam * jnp.eye(Pn, dtype=S.dtype)
        A = jnp.concatenate(
            [jnp.concatenate([S, -T_], axis=1),
             jnp.concatenate([T_, S], axis=1)], axis=0)
        b = jnp.concatenate([mm(Xr.T, dr_) + mm(Xi.T, di_),
                             mm(Xr.T, di_) - mm(Xi.T, dr_)])
        s = jnp.linalg.solve(A, b)
        w = s[:Pn] + 1j * s[Pn:]
        return w.reshape(1, nmodes, Ntaps).astype(seg.dtype)

    def _train_window(w_seg):
        """One sync-search candidate window: short CMA training, returns
        (taps, per-mode complex error variance) — reference :383-385."""
        err, wx = _train(w_seg, TrS_sync, sync_Niter, sync_mu,
                         jnp.asarray(w0_sync), jnp.asarray(sym_sync), "cma")
        em = jnp.mean(err, axis=-1, keepdims=True)
        return wx, jnp.mean(jnp.abs(err - em) ** 2, axis=-1)

    def _sync_train_subset(pr, pi, wlo, wcount):
        """Train candidate windows [wlo, wlo+wcount) of the frame search.

        Windows start at multiples of ``step`` and span two steps, so the
        subset extraction is two shifted reshapes of one contiguous
        (wcount+1)*step slice (no gather). ``wlo`` may be traced (the
        mesh-sharded prefix gives each device its own window range)."""
        blk = (lax.dynamic_slice(pr, (0, (2 + wlo) * step),
                                 (nmodes, (wcount + 1) * step))
               + 1j * lax.dynamic_slice(pi, (0, (2 + wlo) * step),
                                        (nmodes, (wcount + 1) * step)))
        blk = blk.reshape(nmodes, wcount + 1, step)
        win = jnp.concatenate([blk[:, :wcount], blk[:, 1:wcount + 1]],
                              axis=-1)
        return jax.vmap(_train_window)(win.swapaxes(0, 1))

    def _align_heavy(pr, pi, wx_iw, iw, l, fdt):
        """Per-output-mode alignment, heavy part (reference :397-418):
        filter the 2-window segment around the winning start with that
        window's taps, coarse 4th-power FOE, and one batched FFT xcorr of
        BOTH the raw and FOE-derotated hypotheses against every tx pilot
        sequence. Returns the SMALL decision inputs
        (acm2 (2, nmodes) peak metrics, delays2 (2, nmodes), foe_l) — the
        greedy assignment consuming them is tiny traced arithmetic, so
        this heavy part can run sharded per mode on a mesh."""
        seg0 = jnp.asarray(starts)[iw] - sw
        seg = (lax.dynamic_slice(pr, (0, seg0), (nmodes, 2 * sw))
               + 1j * lax.dynamic_slice(pi, (0, seg0), (nmodes, 2 * sw)))
        sy = eqops.apply_filter_to_signal(seg, os, wx_iw)   # (nmodes, Ls)
        f4 = jnp.abs(jnp.fft.fft(sy ** 4, foe_fft, axis=-1)) ** 2
        fvec = jnp.asarray(np.fft.fftfreq(foe_fft) / 4, fdt)
        foe_l = jnp.mean(fvec[jnp.argmax(f4, axis=-1)])
        t = jnp.arange(1, Ls + 1, dtype=fdt)
        rot = jnp.exp(-1j * (2 * np.pi * foe_l) * t).astype(seg.dtype)
        sy2 = jnp.stack([sy[l], sy[l] * rot])               # (2, Ls)
        ac = _xcorr_batched(jnp.asarray(seq_f)[None, :, :],
                            sy2[:, None, :], nxc, nfft)     # (2, nmodes, nxc)
        acr = jnp.maximum(jnp.abs(ac.real), jnp.abs(ac.imag))
        acm2 = jnp.max(acr, axis=-1)                        # (2, nmodes)
        delays2 = -(jnp.argmax(jnp.abs(ac), axis=-1) - (Ls - 1))
        return acm2, delays2, foe_l

    def _greedy_assign(best_w, acm2_rows, delays2_rows, foe_rows, fdt):
        """Greedy mode assignment from the per-mode alignment outputs
        (reference :404-418): all traced arithmetic on (2, nmodes)-sized
        values. Returns (mode_order, shift, sync_corr, foe_coarse)."""
        starts_d = jnp.asarray(starts)
        found = jnp.zeros((nmodes,), dtype=bool)
        mode_order, shifts, peak_acs = [], [], []
        foe_coarse = jnp.zeros((), fdt)
        for l in range(nmodes):
            acm2, delays2, foe_l = (acm2_rows[l], delays2_rows[l],
                                    foe_rows[l])
            hyp = jnp.argmax(acm2, axis=0)                  # (nmodes,)
            acm = jnp.max(acm2, axis=0)
            masked = jnp.where(found, -jnp.inf, acm)
            p = jnp.argmax(masked)
            found = found | (jnp.arange(nmodes) == p)
            delay = delays2[hyp[p], p]
            foe_coarse = jnp.where(jnp.asarray(l == 0),
                                   jnp.where(hyp[p] == 1, foe_l, foe_coarse),
                                   foe_coarse)
            mode_order.append(p)
            peak_acs.append(masked[p])
            shifts.append(starts_d[best_w[l]] - sw + os * delay)
        return (jnp.stack(mode_order), jnp.stack(shifts).astype(jnp.int32),
                jnp.min(jnp.stack(peak_acs)), foe_coarse)


    def _fwd(pr, pi, _frame_base):
        """One full pilot RX: sync -> pilot eq -> filter -> CPE -> payload.

        The capture arrives as real/imag planes ``pr``/``pi`` (nmodes, L);
        complex arrays are built only on the sync/alignment/training
        slices and the frame windows that need them. Returns the complex
        payload and ``info``.

        ``_frame_base`` (traced sample offset) shifts every demodulated
        frame window — the hook the frame-data-parallel mesh receiver
        (parallel/sharded.make_sharded_pilot_rx) uses to give each device
        its own frame range while sync/training stay replicated."""
        L = pr.shape[-1]
        assert pr.shape[0] == nmodes
        assert L >= (frame_len + 2 * seq_len) * os, \
            "Signal must be at least as long as frame"
        fdt = pr.dtype

        # ---- 1. frame sync: batched window search ----------------------
        # windows start at multiples of step and span 2 steps: two shifted
        # (W, step) reshapes instead of a W*sw fancy-index gather
        wxs, evars = _sync_train_subset(pr, pi, 0, W)         # (W,n,n,t), (W,n)
        best_w = jnp.argmin(evars, axis=0)                   # (nmodes,)

        # ---- per-mode alignment: one batched xcorr per output mode -----
        # The reference (:399-401) estimates a coarse FOE from the equalised
        # window by the 4th-power spectral peak and derotates before
        # correlating. That estimate is fragile when the window straddles
        # payload data (a spurious peak smears the pilot phase and collapses
        # the correlation); we correlate BOTH the raw and the FOE-derotated
        # output and keep the stronger hypothesis — robust to genuine
        # offsets (raw collapses, derotated peaks) and to spurious FOE
        # (derotated collapses, raw peaks) at the cost of one extra row in
        # the already-batched FFT. The heavy per-mode part (_align_heavy)
        # feeds the tiny greedy assignment (_greedy_assign, reference
        # :404-418).
        rows = [_align_heavy(pr, pi, wxs[best_w[l]], best_w[l], l, fdt)
                for l in range(nmodes)]
        mode_order, shift, sync_corr, foe_coarse = _greedy_assign(
            best_w, [r[0] for r in rows], [r[1] for r in rows],
            [r[2] for r in rows], fdt)

        # reference sync2frame (signals.py:1709-1744): reorder modes, wrap
        # negative shifts by one frame. The mode reorder happens on the
        # SMALL training slices (a row gather per segment) — never as a
        # whole-capture permutation pass
        shift = shift[mode_order]
        shift = jnp.where(shift < 0, shift + frame_len * os, shift)

        # ---- 2. pilot equalisation (two-stage, vmapped over modes) ------
        eqsh = shift - tap_corr
        eqsh = jnp.where(eqsh < 0, eqsh + frame_len * os, eqsh)
        ref_seq = jnp.asarray(pilot_seq)
        segs = jnp.stack([
            (lax.dynamic_slice(pr, (0, eqsh[i]), (nmodes, seg_len))
             + 1j * lax.dynamic_slice(pi, (0, eqsh[i]), (nmodes, seg_len))
             )[mode_order]
            for i in range(nmodes)])                  # (n, n, seg_len)
        foe_pil = jnp.zeros((), fdt)
        if eq_trainer == "ls":
            assert not foe_comp, \
                "eq_trainer='ls' supports foe_comp=False chains"
            taps = jax.vmap(_ls_taps_mode)(segs, ref_seq)[:, 0]
        else:
            # stage 1: blind warm-up on the pilot alphabet, all modes in one
            # vmapped training (reference :506-520 trains them sequentially)
            w0r = jnp.asarray(w0_eq)[:, None]             # (n, 1, n, Ntaps)
            sym1 = jnp.broadcast_to(jnp.asarray(sym_st1)[None],
                                    (nmodes,) + sym_st1.shape)

            def t_st1(seg, w, s):
                return _train(seg, TrS_eq, Niter, mu[0], w, s, methods[0])[1]

            warm = jax.vmap(t_st1)(segs, w0r, sym1)       # (n, 1, n, Ntaps)
            if foe_comp:
                # pilot FOE: phase slope of conj(ref)*rx (reference :32-73)
                sy = jax.vmap(lambda seg, w:
                              eqops.apply_filter_to_signal(seg, os, w)[0]
                              )(segs, warm)               # (n, Lseq')
                pe = jnp.unwrap(jnp.angle(jnp.conj(ref_seq)
                                          * sy[:, :seq_len]), axis=-1)
                x = jnp.arange(seq_len, dtype=fdt)
                xm = x - x.mean()
                slopes = (jnp.sum(xm * (pe - pe.mean(axis=-1, keepdims=True)),
                                  axis=-1) / jnp.sum(xm * xm)) / (2 * np.pi)
                foe_pil = jnp.mean(slopes)
                ts = jnp.arange(1, seg_len + 1, dtype=fdt)
                segs = segs * jnp.exp(-1j * (2 * np.pi * foe_pil / os)
                                      * ts).astype(segs.dtype)
            # stages 2+3 (reference :530-554): retrain from the warm taps
            w_k = warm
            for k, (mu_k, m_k) in enumerate(((mu[0], methods[0]),
                                             (mu[1], methods[1]))):
                if da[k]:
                    s_k = ref_seq[:, None, :]
                else:
                    sk = eqops._reshape_symbols(None, m_k, M_pilot, dtype, 1)
                    s_k = jnp.broadcast_to(jnp.asarray(sk)[None],
                                           (nmodes,) + sk.shape)

                def t_k(seg, w, s, _mu=mu_k, _m=m_k):
                    return _train(seg, TrS_eq, Niter, _mu, w, s, _m)[1]

                w_k = jax.vmap(t_k)(segs, w_k, s_k)
            taps = w_k[:, 0]                              # (n, n, Ntaps)
        # the capture stays unpermuted: the mode permutation folds into the
        # taps' input axis (out_i = sum_j taps[i,j] E[mo[j]]
        # == sum_p taps[i, inv[p]] E[p])
        return _demod(pr, pi, eqsh, taps, fdt, _frame_base, shift,
                      sync_corr, foe_coarse, foe_pil, mode_order)

    def forward(E, _frame_base=0):
        """One full pilot RX: sync -> pilot eq -> filter -> CPE -> payload.
        Complex (nmodes, L) capture in, complex payload out."""
        return _fwd(E.real, E.imag, _frame_base)

    def forward_planes(pr, pi, _frame_base=0):
        """``forward`` with the capture as float32 real/imag planes and the
        payload returned as a ``(dr, di)`` plane pair (equal to
        ``forward``'s); ``info`` is identical to ``forward``'s."""
        data, info = _fwd(pr, pi, _frame_base)
        return (data.real, data.imag), info

    def _train_mode_taps(pr, pi, eqsh_i, mode_order, i):
        """Two-stage pilot equalisation for ONE output mode ``i`` (may be
        traced): the per-mode body of ``_fwd``'s vmapped stage-1/2/3
        trainings (reference :454-554), exposed separately so a mesh can
        shard the independent per-mode trainings across device groups.
        Same segment slice, tap init, symbol sets, stage order and
        hyperparameters as the vmapped path (equality to reduction-order
        ulps pinned by tests/test_pilot_chain.py::
        test_sharded_prefix_matches_replicated).
        Returns the (1, nmodes, Ntaps) tap row of mode ``i``."""
        seg = (lax.dynamic_slice(pr, (0, eqsh_i), (nmodes, seg_len))
               + 1j * lax.dynamic_slice(pi, (0, eqsh_i),
                                        (nmodes, seg_len)))[mode_order]
        if eq_trainer == "ls":
            return _ls_taps_mode(seg, jnp.asarray(pilot_seq)[i])
        w = jnp.asarray(w0_eq)[i][None]               # (1, nmodes, Ntaps)
        w = _train(seg, TrS_eq, Niter, mu[0], w, jnp.asarray(sym_st1),
                   methods[0])[1]
        for k, (mu_k, m_k) in enumerate(((mu[0], methods[0]),
                                         (mu[1], methods[1]))):
            if da[k]:
                s_k = jnp.asarray(pilot_seq)[i][None]  # (1, seq_len)
            else:
                sk = eqops._reshape_symbols(None, m_k, M_pilot, dtype, 1)
                s_k = jnp.asarray(sk)
            w = _train(seg, TrS_eq, Niter, mu_k, w, s_k, m_k)[1]
        return w

    def prefix_sharded(pr, pi, axis_name, ndev):
        """Cold-start prefix distributed over a mesh axis (inside
        shard_map): the three replicated-prefix terms of the
        frame-parallel receiver each run sharded —

        * the W candidate-window sync trainings (the dominant term) are
          split into contiguous chunks per device; the per-window error
          variances/taps are independent, so only the tiny
          (ndev, nmodes) min/index arrays and the winning taps are
          all-gathered;
        * the per-mode alignment heavy part (filter + 4th-power FOE FFT +
          batched xcorr) runs on device d for mode d % nmodes;
        * the per-mode two-stage pilot trainings likewise.

        The greedy assignment consumes only gathered (2, nmodes)-sized
        values and runs replicated (identical on every device). Requires
        ``ndev >= nmodes`` and a ``foe_comp=False`` chain (the pilot-FOE
        average couples all modes; the default chain does not use it).
        Returns ``(taps, shift, mode_order, sync_corr, foe_coarse)`` —
        exactly the state ``forward_tracking`` consumes, identical on
        every device. Addresses the Amdahl bound of the replicated
        prefix: the prefix cost per
        device drops ~W/ndev for the search and ~1/min(ndev, nmodes)
        for alignment + training instead of staying constant."""
        assert not foe_comp, \
            "prefix_sharded supports foe_comp=False chains (the pilot-FOE " \
            "average couples modes; train replicated for foe_comp=True)"
        assert ndev >= nmodes, "prefix_sharded needs ndev >= nmodes"
        fdt = pr.dtype
        d = lax.axis_index(axis_name)
        chunk = -(-W // int(ndev))
        # clamp the last device's range into [0, W) — overlap means a few
        # windows are trained twice, which is harmless (identical results)
        # and keeps every shape static
        wlo = jnp.minimum(d * chunk, W - chunk)
        wxs_l, evars_l = _sync_train_subset(pr, pi, wlo, chunk)
        loc_arg = jnp.argmin(evars_l, axis=0)             # (nmodes,)
        loc_val = jnp.min(evars_l, axis=0)
        vals = lax.all_gather(loc_val, axis_name)         # (ndev, nmodes)
        gidx = lax.all_gather(wlo + loc_arg, axis_name)   # (ndev, nmodes)
        dev_best = jnp.argmin(vals, axis=0)               # (nmodes,)
        best_w = gidx[dev_best, jnp.arange(nmodes)]
        # the winning windows' taps: gather the (ndev, chunk, n, n, t)
        # tap stack (tiny — taps, not signals) and index (device, offset)
        wxs_all = lax.all_gather(wxs_l, axis_name)
        wlo_of = jnp.minimum(jnp.arange(ndev) * chunk, W - chunk)
        off = best_w - wlo_of[dev_best]
        l_d = d % nmodes
        acm2_d, delays2_d, foe_d = _align_heavy(
            pr, pi, wxs_all[dev_best[l_d], off[l_d]], best_w[l_d], l_d, fdt)
        acm2_g = lax.all_gather(acm2_d, axis_name)        # (ndev, 2, n)
        delays2_g = lax.all_gather(delays2_d, axis_name)
        foe_g = lax.all_gather(foe_d, axis_name)
        # device l computed mode l's row (l_d == l for l < nmodes)
        mode_order, shift, sync_corr, foe_coarse = _greedy_assign(
            best_w, [acm2_g[l] for l in range(nmodes)],
            [delays2_g[l] for l in range(nmodes)],
            [foe_g[l] for l in range(nmodes)], fdt)
        shift = shift[mode_order]
        shift = jnp.where(shift < 0, shift + frame_len * os, shift)
        eqsh = shift - tap_corr
        eqsh = jnp.where(eqsh < 0, eqsh + frame_len * os, eqsh)
        w_row = _train_mode_taps(pr, pi, eqsh[l_d], mode_order, l_d)
        rows_g = lax.all_gather(w_row[0], axis_name)      # (ndev, n, t)
        taps = rows_g[:nmodes]
        return taps, shift, mode_order, sync_corr, foe_coarse


    def _demod(pr, pi, eqsh, taps, fdt, _frame_base, shift, sync_corr,
               foe_coarse, foe_pil, mode_order):
        # ---- 3+4. filter + pilot CPE per requested frame -----------------
        # shared by the full chain (after sync+training) and the tracking
        # warm-start entries below; ``taps`` are the logical taps (output
        # mode i, tx-ordered input j) and ``mode_order`` the found mode
        # permutation, folded into the taps' input axis
        fr_len = frame_len * os + Ntaps - 1
        taps_eff = taps[:, jnp.argsort(mode_order)]
        if foe_comp:
            # e^{-i th} (r + i q) in split planes
            t = jnp.arange(1, pr.shape[-1] + 1, dtype=fdt)
            th = (2 * np.pi * foe_pil / os) * t
            c_t, s_t = jnp.cos(th), jnp.sin(th)
            pr, pi = pr * c_t + pi * s_t, pi * c_t - pr * s_t
        pil_c = jnp.asarray(pil_cpe)
        ph_idx_d = jnp.asarray(ph_idx)
        dat_idx_d = jnp.asarray(dat_idx)
        wgt = (jnp.arange(cpe_dx, dtype=jnp.float32) / cpe_dx)[None, None, :]

        def filtered(base, n):
            """(nmodes, (n - Ntaps)//os + 1) symbols of the window of ``n``
            samples at capture offset ``base`` (traced); output mode i
            reads the capture at its own shift eqsh[i]."""
            return jnp.stack([
                eqops.apply_filter_to_signal(
                    lax.dynamic_slice(pr, (0, eqsh[i] + base), (nmodes, n))
                    + 1j * lax.dynamic_slice(pi, (0, eqsh[i] + base),
                                             (nmodes, n)),
                    os, taps_eff[i:i + 1])[0]
                for i in range(nmodes)])

        def interp_uniform(ph_avg):
            """Linear interp over the uniform pilot grid, clamped at the
            edges (jnp.interp semantics) — broadcast+reshape, gather-free.
            Works for any leading batch dims (mode, [frame])."""
            lead = ph_avg.shape[:-1]
            npts = ph_avg.shape[-1]
            w1 = wgt.reshape((1,) * len(lead) + (1, cpe_dx))
            lo = ph_avg[..., :-1, None]
            hi = ph_avg[..., 1:, None]
            mid = (lo + (hi - lo) * w1).reshape(*lead, (npts - 1) * cpe_dx)
            head = jnp.broadcast_to(ph_avg[..., :1], lead + (cpe_x0,))
            tail_len = frame_len - cpe_x0 - (npts - 1) * cpe_dx
            tail = jnp.broadcast_to(ph_avg[..., -1:], lead + (tail_len,))
            return jnp.concatenate([head, mid, tail], axis=-1)

        def cpe_frames(sym):
            """Pilot CPE (reference :258-327) batched over (nmodes, nframes,
            frame_len): extract the phase pilots, unwrap, cumsum moving
            average, linear interpolation, derotate, extract the payload."""
            nf = sym.shape[1]
            if blocked_cpe:
                tail = sym[:, :, seq_len:].reshape(nmodes, nf, nblk_cpe,
                                                   pilot_ins_rat)
                rec_pil = tail[:, :, :, 0]
            else:
                rec_pil = sym[:, :, ph_idx_d]
            res_ph = jnp.unwrap(jnp.angle(jnp.conj(pil_c)[:, None]
                                          * rec_pil), axis=-1)
            z = jnp.zeros((nmodes, nf, 1), res_ph.dtype)
            cs = jnp.cumsum(jnp.concatenate([z, res_ph], axis=-1), axis=-1)
            ph_avg = (cs[..., cpe_avg:] - cs[..., :-cpe_avg]) / cpe_avg
            trace = interp_uniform(ph_avg)
            out = sym * jnp.exp(-1j * trace).astype(sym.dtype)
            if blocked_cpe:
                tl = out[:, :, seq_len:].reshape(nmodes, nf, nblk_cpe,
                                                 pilot_ins_rat)
                dat = tl[:, :, :, 1:].reshape(nmodes, nf, -1)
            else:
                dat = out[:, :, dat_idx_d]
            return dat, trace

        def do_frame(_, base):
            """Demodulate one frame at capture offset ``base`` (traced)."""
            dat, trace = cpe_frames(filtered(base, fr_len)[:, None])
            return None, (dat[:, 0], trace[:, 0] if return_phase else None)

        info = {"shift": shift, "sync_corr": sync_corr,
                "foe": foe_coarse + foe_pil, "foe_pil": foe_pil,
                "taps": taps, "mode_order": mode_order}
        bases = (jnp.asarray([int(f) * frame_len * os for f in frames])
                 + _frame_base)
        if frames_mode == "span":
            # hoist the filter OUT of the frame loop: frames are contiguous
            # and the taps are frozen, so one windows-batched contraction
            # per output mode covers the whole multi-frame span (identical
            # window indices to the per-frame slices), then the CPE runs
            # frame-batched
            if not (len(frames) > 2 and tuple(frames) == tuple(
                    range(int(frames[0]), int(frames[0]) + len(frames)))):
                raise ValueError(
                    "frames_mode='span' needs >2 contiguous frames, got %r; "
                    "use frames_mode='scan' for arbitrary frame sets"
                    % (tuple(frames),))
            nfp = len(frames)
            base0 = int(frames[0]) * frame_len * os + _frame_base
            sym_all = filtered(base0, nfp * frame_len * os + Ntaps - 1)
            dat_b, trace_b = cpe_frames(
                sym_all.reshape(nmodes, nfp, frame_len))
            if return_phase:
                info["phase"] = trace_b.reshape(nmodes, -1)
            return dat_b.reshape(nmodes, -1), info
        if len(frames) > 2:
            # one traced frame body regardless of frame count (an unrolled
            # loop at 20 frames takes XLA tens of minutes to compile):
            # vmap batches every frame's filter into one contraction; scan
            # bounds memory for very large dispatches. frames_unroll
            # replicates the scan body that many times per loop iteration
            # (cross-frame fusion without the full-unroll compile blowup)
            if frames_mode == "vmap":
                data_f, traces_f = jax.vmap(
                    lambda b: do_frame(None, b)[1])(bases)
            else:
                _, (data_f, traces_f) = lax.scan(do_frame, None, bases,
                                                 unroll=frames_unroll)
        else:
            pairs = [do_frame(None, b)[1] for b in bases]
            data_f = jnp.stack([p[0] for p in pairs])
            traces_f = (jnp.stack([p[1] for p in pairs])
                        if return_phase else None)
        if return_phase:
            info["phase"] = jnp.moveaxis(traces_f, 0, 1).reshape(nmodes, -1)
        return jnp.moveaxis(data_f, 0, 1).reshape(nmodes, -1), info

    def _tracking(pr, pi, wxy, shift, mode_order, foe, _frame_base):
        fdt = pr.dtype
        if foe is not None and not foe_comp:
            raise ValueError("foe= supplied but the chain was built with "
                             "foe_comp=False (it would not be applied)")
        if foe_comp and foe is None:
            import warnings
            warnings.warn(
                "chain built with foe_comp=True but the tracking entry got "
                "no foe=: the frozen taps were trained on FOE-compensated "
                "segments while this capture is demodulated uncompensated; "
                "pass the previous dispatch's info['foe']", stacklevel=3)
        shift = jnp.asarray(shift, jnp.int32)
        eqsh = shift - tap_corr
        eqsh = jnp.where(eqsh < 0, eqsh + frame_len * os, eqsh)
        z = jnp.zeros((), fdt)
        foe_t = z if foe is None else jnp.asarray(foe, fdt)
        mo = (jnp.arange(nmodes) if mode_order is None
              else jnp.asarray(mode_order))
        return _demod(pr, pi, eqsh, jnp.asarray(wxy), fdt, _frame_base,
                      shift, jnp.array(np.inf, fdt), z, foe_t, mo)

    def forward_tracking(E, wxy, shift, mode_order=None, foe=None,
                         _frame_base=0):
        """Warm-start (tracking) serving entry: demodulate frames with
        taps/shift from a previous dispatch, skipping frame sync and the
        two-stage pilot training entirely (zero fixed prefix).

        ``wxy`` is the (nmodes, nmodes, Ntaps) tap array and ``shift`` the
        per-mode frame offsets — exactly ``info["taps"]``/``info["shift"]``
        of a previous ``forward`` call; ``mode_order`` is the previous
        dispatch's mode permutation. This is the steady-state pattern the
        reference reaches with ``wxinit=`` warm-starting across frames
        (qampy/equalisation.py:386-388). When the chain was built with
        ``foe_comp=True`` the frozen taps were trained on FOE-compensated
        segments — pass the previous dispatch's ``info["foe"]`` as ``foe``
        so the capture is derotated the same way (omitting it warns and
        demodulates uncompensated). ``info["sync_corr"]`` is +inf to mark
        sync-not-run. Returns the same payload as ``forward`` given the
        same state."""
        return _tracking(E.real, E.imag, wxy, shift, mode_order, foe,
                         _frame_base)

    def forward_tracking_planes(pr, pi, wxy, shift, mode_order=None,
                                foe=None, _frame_base=0):
        """``forward_tracking`` with the capture as float32 real/imag
        planes and the payload returned as a ``(dr, di)`` plane pair."""
        data, info = _tracking(pr, pi, wxy, shift, mode_order, foe,
                               _frame_base)
        return (data.real, data.imag), info

    forward.tracking = forward_tracking
    forward.tracking_planes = forward_tracking_planes
    forward.planes = forward_planes
    forward.prefix_sharded = prefix_sharded
    forward.backend_info = {"family": "xla", "pallas": False,
                            "methods": tuple(methods),
                            "trainer": ("ls(closed form)"
                                        if eq_trainer == "ls"
                                        else "block(xla, vmapped)"),
                            "eq_trainer": eq_trainer}
    return forward

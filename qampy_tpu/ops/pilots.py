"""Pilot-based receiver: frame sync, pilot equalisation, FOE and CPE.

Parity: qampy/core/pilotbased_receiver.py in the reference. The frame search
(reference :329-434), which runs ~40 independent short CMA trainings in a
Python loop, is batched here into ONE vmapped training over all candidate
windows — the windows dimension becomes a batch axis on the device. The
orchestration (argmin window, greedy mode assignment) stays host-side since
it runs once per signal and is inherently data-dependent.
"""
from __future__ import annotations

import warnings

import numpy as np
import jax
import jax.numpy as jnp

from qampy_tpu.ops import equaliser, phase
from qampy_tpu.core import sync as ber_functions
from qampy_tpu.core import filter as core_filter

#: frame sync declares failure below this autocorrelation (reference :369)
FRAME_SYNC_THRS = 120


def pilot_based_foe(rec_symbs, pilot_symbs):
    """FOE from the phase slope between aligned rx and tx pilots.

    Parity: reference core/pilotbased_receiver.py:32-73.
    Returns (foe, foePerMode, condNum).
    """
    rec_symbs = jnp.atleast_2d(jnp.asarray(rec_symbs))
    pilot_symbs = jnp.atleast_2d(jnp.asarray(pilot_symbs))
    phase_evo = jnp.unwrap(jnp.angle(jnp.conj(pilot_symbs) * rec_symbs), axis=-1)
    N = phase_evo.shape[-1]
    x = jnp.arange(N, dtype=phase_evo.dtype)
    # first-order polyfit per mode (vectorised least squares)
    xm = x - x.mean()
    slope = jnp.sum(xm * (phase_evo - phase_evo.mean(axis=-1, keepdims=True)), axis=-1) / jnp.sum(xm * xm)
    intercept = phase_evo.mean(axis=-1) - slope * x.mean()
    foePerMode = (slope / (2 * np.pi))[:, None]
    condNum = intercept[:, None]
    return jnp.mean(foePerMode), foePerMode, condNum


def frame_sync(rx_signal, ref_symbs, os, frame_len=2 ** 16, M_pilot=4, mu=1e-3,
               Ntaps=17, **eqargs):
    """Locate the pilot sequence in the frame via batched windowed CMA search.

    Parity: reference core/pilotbased_receiver.py:329-434. Returns
    (shift_factor, coarse_foe, mode_sync_order, wx1, sync_bool).

    Note: this granular entry deliberately fetches the batched window
    metrics to the host for the tiny greedy mode assignment (numpy return
    values are its contract, mirroring the reference); the serving path
    (ops/pilot_chain.make_pilot_rx_chain) runs the same search fully
    on-device with traced argmax/dynamic_slice. Equality of the two
    implementations is pinned by
    tests/test_pilot_chain.py::test_matches_granular_chain.
    """
    sync_bool = True
    rx_signal = np.atleast_2d(np.asarray(rx_signal))
    ref_symbs = np.atleast_2d(np.asarray(ref_symbs))
    pilot_seq_len = ref_symbs.shape[-1]
    nmodes = rx_signal.shape[0]
    assert rx_signal.shape[-1] >= (frame_len + 2 * pilot_seq_len) * os, \
        "Signal must be at least as long as frame"
    if "method" in eqargs:
        if eqargs["method"] in equaliser.REAL_VALUED:
            if np.iscomplexobj(rx_signal):
                raise ValueError("using a real-valued equaliser in frame sync is unsupported")
        elif eqargs["method"] in equaliser.DATA_AIDED:
            raise ValueError("using a data-aided equaliser in frame sync is unsupported")
    mode_sync_order = np.zeros(nmodes, dtype=int)
    not_found_modes = np.arange(0, nmodes)
    search_overlap = 2
    search_window = pilot_seq_len * os
    step = search_window // search_overlap
    num_steps = (frame_len * os) // step + 1
    # ---- batched window search (one vmapped training instead of a loop) ----
    starts = np.arange(search_overlap, num_steps) * step
    windows = np.stack([rx_signal[:, s:s + search_window] for s in starts])  # (W, nmodes, win)
    method = eqargs.pop("method", "cma")
    Niter = eqargs.pop("Niter", 1)
    adaptive = eqargs.pop("adaptive_stepsize", False)
    TrSyms = equaliser._cal_training_symbol_len(os, Ntaps, search_window)
    symbols = equaliser._reshape_symbols(None, method, M_pilot, windows.dtype, nmodes)
    w0 = jnp.asarray(equaliser._init_taps(Ntaps, nmodes, nmodes, windows.dtype))

    def train_window(win):
        err, wxy, _ = equaliser.train_equaliser_seq(
            win, TrSyms, int(Niter), int(os), float(mu), w0, jnp.asarray(symbols),
            method, adaptive=bool(adaptive))
        return wxy, jnp.var(err, axis=-1)

    wxys_b, vars_b = jax.vmap(train_window)(jnp.asarray(windows))
    sub_vars = np.ones((nmodes, num_steps)) * 1e2
    sub_vars[:, search_overlap:] = np.asarray(vars_b).T
    wxys = np.zeros((num_steps, nmodes, nmodes, Ntaps), dtype=rx_signal.dtype)
    wxys[search_overlap:] = np.asarray(wxys_b)
    # ---- pick the lowest-error window per mode, then align sequences ----
    # All nmodes alignment segments are filtered, FOE-corrected and
    # correlated against every tx pilot sequence in ONE batched device
    # computation (the reference loops nmodes x nmodes host-side FFTs,
    # :397-418); only the tiny greedy assignment runs on fetched values.
    min_range = np.argmin(sub_vars, axis=-1)
    wxy = wxys[min_range]
    segs = np.stack([rx_signal[:, m * step - search_window: m * step + search_window]
                     for m in min_range])            # (nmodes, nmodes, 2sw)
    symbs_b = jax.vmap(lambda s, w: equaliser.apply_filter(s, os, w))(
        jnp.asarray(segs), jnp.asarray(wxy))          # (nmodes, nmodes, Ls)
    foe_b = jax.vmap(phase.find_freq_offset)(symbs_b)  # (nmodes, nmodes, 1)
    symbs_b = jax.vmap(phase.comp_freq_offset)(symbs_b, foe_b)
    # rows of interest: segment l's own output mode l
    sy = symbs_b[jnp.arange(nmodes), jnp.arange(nmodes)]  # (nmodes, Ls)
    Ls = sy.shape[-1]
    n = pilot_seq_len + Ls - 1
    nfft = int(2 ** np.ceil(np.log2(n)))
    Xf = jnp.fft.fft(jnp.asarray(ref_symbs), nfft, axis=-1)  # (nmodes, nfft)
    Yf = jnp.fft.fft(jnp.conj(sy)[:, ::-1], nfft, axis=-1)
    ac = jnp.fft.ifft(Xf[None, :, :] * Yf[:, None, :], axis=-1)[..., :n]
    # find_sequence_offset_complex semantics: delay from argmax |ac|, the
    # quality metric is the rotation-max of the real part
    acr = jnp.maximum(jnp.abs(ac.real), jnp.abs(ac.imag))
    acm = np.asarray(jnp.max(acr, axis=-1))           # (l, ref_pol)
    delays = np.asarray(-(jnp.argmax(jnp.abs(ac), axis=-1) - (Ls - 1)))
    foe_host = np.asarray(foe_b)
    shift_factor = np.zeros(nmodes, dtype=int)
    foe_corse = foe_host[0]
    for l in range(nmodes):
        masked = np.where(np.isin(np.arange(nmodes), not_found_modes),
                          acm[l], -np.inf)
        max_sync_pol = int(np.argmax(masked))
        if masked[max_sync_pol] < FRAME_SYNC_THRS:
            warnings.warn("Very low autocorrelation, likely the frame-sync failed")
            sync_bool = False
        mode_sync_order[l] = max_sync_pol
        not_found_modes = not_found_modes[not_found_modes != max_sync_pol]
        shift_factor[l] = (min_range[l] * step
                           + os * int(delays[l, max_sync_pol]) - search_window)
        foe_corse = foe_host[l]                       # reference keeps the last
    wx1 = wxy[nmodes - 1]
    return shift_factor, np.asarray(foe_corse), mode_sync_order, np.asarray(wx1), sync_bool


def correct_shifts(shift_factors, ntaps, os):
    """Correct shift factors for differing tap counts (reference :436-443)."""
    shift_factors = np.asarray(shift_factors)
    if not ((ntaps[1] - ntaps[0]) % os == 0):
        raise ValueError("Taps for search and convergence improperly configured")
    return shift_factors - int((ntaps[1] - ntaps[0]) / 2)


def shift_signal(sig, shift_factors):
    """Roll each mode by its shift factor (reference :445-452)."""
    sig = jnp.asarray(sig)
    k = len(shift_factors)
    if k > 1:
        rows = [jnp.roll(sig[i], -int(shift_factors[i])) for i in range(k)]
        return jnp.stack(rows)
    return jnp.roll(sig, int(np.asarray(shift_factors).flatten()[0]), axis=-1)


def equalize_pilot_sequence(rx_signal, ref_symbs, shift_fctrs, os, foe_comp=False,
                            mu=(1e-4, 1e-4), M_pilot=4, Ntaps=45, Niter=30,
                            adaptive_stepsize=True, methods=('cma', 'cma'),
                            wxinit=None, backend="auto"):
    """Two-stage data-aided equalisation over the pilot sequence.

    Parity: reference core/pilotbased_receiver.py:454-554. Returns
    (out_taps, foe_all). ``backend`` follows
    ``ops.equaliser._resolve_backend`` ("auto" = exact scan on CPU,
    block trainer on an accelerator).
    """
    rx_signal = jnp.atleast_2d(jnp.asarray(rx_signal))
    ref_symbs = jnp.atleast_2d(jnp.asarray(ref_symbs))
    npols = rx_signal.shape[0]
    pilot_seq_len = ref_symbs.shape[-1]
    wx = wxinit
    if methods[0] in equaliser.REAL_VALUED:
        if methods[1] not in equaliser.REAL_VALUED:
            raise ValueError("Using a complex and real-valued equalisation method is not supported")
    elif methods[1] in equaliser.REAL_VALUED:
        raise ValueError("Using a complex and real-valued equalisation method is not supported")
    shift_fctrs = np.asarray(shift_fctrs)
    kw = dict(adaptive_stepsize=adaptive_stepsize, backend=backend)
    if np.unique(shift_fctrs).shape[0] > 1:
        syms_out = jnp.zeros_like(ref_symbs)
        for i in range(npols):
            rx_sig_mode = rx_signal[:, shift_fctrs[i]: shift_fctrs[i] + pilot_seq_len * os + Ntaps - 1]
            s_i, wx, err = equaliser.equalise_signal(
                rx_sig_mode, os, mu[0], M_pilot, wxy=wx, Ntaps=Ntaps, Niter=Niter,
                method=methods[0], apply=True, modes=[i], **kw)
            syms_out = syms_out.at[i].set(s_i[i])
    else:
        rx_sig_mode = rx_signal[:, shift_fctrs[0]: shift_fctrs[0] + pilot_seq_len * os + Ntaps - 1]
        syms_out, wx, err = equaliser.equalise_signal(
            rx_sig_mode, os, mu[0], M_pilot, wxy=wxinit, Ntaps=Ntaps, Niter=Niter,
            method=methods[0], apply=True, **kw)
    if foe_comp:
        foe, foePerMode, cond = pilot_based_foe(syms_out, ref_symbs)
        foe_all = np.ones(foePerMode.shape) * float(foe)
    else:
        foe_all = np.zeros([npols, 1])
        foePerMode = foe_all
    out_taps = jnp.asarray(wx)
    if np.unique(shift_fctrs).shape[0] > 1:
        for i in range(npols):
            rx_sig_mode = rx_signal[:, shift_fctrs[i]: shift_fctrs[i] + pilot_seq_len * os + Ntaps - 1]
            if foe_comp:
                rx_sig_mode = phase.comp_freq_offset(rx_sig_mode, foe_all, os=os)
            out_taps, err = equaliser.equalise_signal(
                rx_sig_mode, os, mu[0], M_pilot, wxy=out_taps, Ntaps=Ntaps, Niter=Niter,
                method=methods[0], modes=[i], symbols=ref_symbs, **kw)
            out_taps, err = equaliser.equalise_signal(
                rx_sig_mode, os, mu[1], 4, wxy=out_taps, Ntaps=Ntaps, Niter=Niter,
                method=methods[1], modes=[i], symbols=ref_symbs, **kw)
    else:
        rx_sig_mode = rx_signal[:, shift_fctrs[0]: shift_fctrs[0] + pilot_seq_len * os + Ntaps - 1]
        if foe_comp:
            rx_sig_mode = phase.comp_freq_offset(rx_sig_mode, foe_all, os=os)
        out_taps, err = equaliser.equalise_signal(
            rx_sig_mode, os, mu[0], M_pilot, wxy=out_taps, Ntaps=Ntaps, Niter=Niter,
            method=methods[0], symbols=ref_symbs, **kw)
        out_taps, err = equaliser.equalise_signal(
            rx_sig_mode, os, mu[1], M_pilot, wxy=out_taps, Niter=Niter,
            method=methods[1], symbols=ref_symbs, **kw)
    return np.asarray(out_taps), foe_all


def pilot_based_cpe(signal, pilot_symbs, pilot_idx, frame_len, seq_len=None,
                    num_average=1, use_pilot_ratio=1, max_num_blocks=None, nframes=1):
    """Pilot-aided carrier phase estimation with moving-average smoothing.

    Parity: reference core/pilotbased_receiver.py:258-327
    (``pilot_based_cpe_new`` — the living implementation).
    Returns (compensated signal, phase trace), truncated to nframes*frame_len.
    """
    assert num_average > 1, "need to take average over at least 3"
    if not (num_average % 2):
        num_average += 1
        warnings.warn("Number of averages should be odd, adding one average, num_average={}".format(num_average))
    signal = jnp.atleast_2d(jnp.asarray(signal))
    pilot_symbs = jnp.atleast_2d(jnp.asarray(pilot_symbs))
    pilot_idx = np.asarray(pilot_idx)
    pilot_idx_new = pilot_idx[:max_num_blocks:use_pilot_ratio]
    nlen = min(frame_len * nframes, signal.shape[-1])
    frl = np.arange(nframes) * frame_len
    pilot_idx_full = np.ravel(pilot_idx_new[None, :] + frl[:, None])
    pilot_idx_full = pilot_idx_full[pilot_idx_full < nlen]
    rec_pilots = signal[:, pilot_idx_full]
    pilot_symbs = jnp.tile(pilot_symbs[:, ::use_pilot_ratio], (1, nframes))[:, :rec_pilots.shape[-1]]
    assert rec_pilots.shape == pilot_symbs.shape, \
        "Improper pilot configuration, the number of received pilots differs from reference ones"
    assert pilot_symbs.shape[-1] >= num_average, \
        "Improper pilot symbol configuration. Averaging block larger than number of pilots"
    res_phase = jnp.unwrap(jnp.angle(jnp.conj(pilot_symbs) * rec_pilots), axis=-1)
    res_phase_avg = core_filter.moving_average(res_phase, num_average)
    i_adj = int((num_average - 1) / 2)
    idx_avg = pilot_idx_full[i_adj:-i_adj]
    assert idx_avg.shape[-1] == res_phase_avg.shape[-1], \
        "averaged phase and new indices are not the same shape"
    idxnew = jnp.arange(0, nlen)
    phase_trace = jax.vmap(lambda p: jnp.interp(idxnew, jnp.asarray(idx_avg), p))(res_phase_avg)
    sig_out = signal[:, :nlen] * jnp.exp(-1j * phase_trace).astype(signal.dtype)
    return sig_out[:, :nframes * frame_len], phase_trace[:, :nframes * frame_len]


# keep the reference name available
pilot_based_cpe_new = pilot_based_cpe


def pilot_based_cpe_legacy(rec_symbs, pilot_symbs, pilot_ins_ratio,
                           num_average=1, use_pilot_ratio=1,
                           max_num_blocks=None, remove_phase_pilots=True):
    """Legacy block-structured pilot CPE (reference ``pilot_based_cpe``).

    Parity: reference core/pilotbased_receiver.py:167-256. ``rec_symbs``
    comes in blocks of ``pilot_ins_ratio`` symbols whose FIRST symbol is a
    pilot; the phase is averaged over ``num_average`` pilots (forced odd),
    edge blocks take the raw first phases / the last averaged phase, and
    the trace is linearly interpolated per block. Superseded in the
    reference itself by ``pilot_based_cpe_new`` (:258-327, which is what
    ``phaserec.pilot_cpe`` and this package's serving chain use); kept for
    API parity under a ``_legacy`` suffix because the living
    ``pilot_based_cpe`` name here carries the _new signature.

    Note: the reference hard-codes 2 modes in its edge-extension
    (``t2 = pp2[:, -1].reshape(2, 1)``, :245) — this port uses the
    mode-count-agnostic equivalent ``avg[:, -1:]``.

    Returns (data_symbs, phase_trace).
    """
    rec_symbs = jnp.atleast_2d(jnp.asarray(rec_symbs))
    pilot_symbs = jnp.atleast_2d(jnp.asarray(pilot_symbs))
    ins = int(pilot_ins_ratio)
    upr = int(use_pilot_ratio)
    num_blocks = rec_symbs.shape[-1] // ins
    if max_num_blocks is not None and num_blocks > max_num_blocks:
        num_blocks = int(max_num_blocks)
    if num_blocks % upr:
        num_blocks -= num_blocks % upr
    rec_pilots = rec_symbs[:, ::ins][:, :num_blocks]
    rec_symbs = rec_symbs[:, : ins * num_blocks]
    # clamp against the number of reference pilots (reference :210-216)
    num_ref = pilot_symbs.shape[-1]
    if num_blocks > num_ref:
        num_blocks = num_ref
        rec_symbs = rec_symbs[:, : num_blocks * ins]
        rec_pilots = rec_pilots[:, :num_blocks]
    elif num_ref > num_blocks:
        pilot_symbs = pilot_symbs[:, :num_blocks]
    if upr >= pilot_symbs.shape[-1]:
        raise ValueError(
            "Can not use every %d pilots since only %d pilot symbols are "
            "present" % (upr, pilot_symbs.shape[-1]))
    rec_pilots = rec_pilots[:, ::upr]
    pilot_symbs = pilot_symbs[:, ::upr]
    if pilot_symbs.shape[-1] <= num_average:
        raise ValueError(
            "Inpropper pilot symbol configuration. Larger averaging block "
            "size than total number of pilot symbols")
    if not num_average % 2:
        num_average += 1
    base = jnp.unwrap(jnp.angle(jnp.conj(pilot_symbs) * rec_pilots), axis=-1)
    avg = core_filter.moving_average(base, num_average)
    half = (num_average - 1) // 2
    pilot_phase = jnp.concatenate(
        [base[:, :half], avg,
         jnp.broadcast_to(avg[:, -1:], base[:, :half].shape)], axis=-1)
    npts = pilot_phase.shape[-1]
    pos = np.arange(0, npts * ins * upr, ins * upr)
    pos_new = np.arange(0, npts * ins * upr)
    phase_trace = jax.vmap(
        lambda p: jnp.interp(jnp.asarray(pos_new).astype(p.dtype),
                             jnp.asarray(pos).astype(p.dtype), p))(pilot_phase)
    data_symbs = rec_symbs * jnp.exp(-1j * phase_trace).astype(rec_symbs.dtype)
    if remove_phase_pilots:
        keep = np.ones(data_symbs.shape[-1], dtype=bool)
        keep[np.arange(0, data_symbs.shape[-1], ins)] = False
        data_symbs = data_symbs[:, np.nonzero(keep)[0]]
    return data_symbs, phase_trace

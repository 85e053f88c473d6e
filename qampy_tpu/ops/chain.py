"""Fused single-dispatch blind RX chain (the production serving path).

``make_rx_chain`` builds one jittable function that runs the reference's
canonical blind receiver — two-stage adaptive MIMO equalisation, tap-frozen
filtering, blind phase search, unwrap and derotation — as a single XLA
program. The block-LMS trainer runs as a hand-written kernel where the
platform has one (ops/_backend.py); every other stage is plain XLA.

Parity workload: reference Scripts/64_qam_equalisation.py:15-28
(dual-pol 64-QAM, MCMA -> MDDMA -> BPS). The step-by-step equivalent
through the granular API is::

    s, wxy, err = equalisation.dual_mode_equalisation(sig, (mu, mu), Ntaps,
                                                      methods=methods)
    rec, ph = phaserec.bps(s, bps_angles, bps_N)

make_rx_chain fuses the same math into one dispatch with the fast
train-on-prefix/apply-to-all discipline (reference
``equalise_signal(TrSyms=...)`` + ``apply_filter``,
qampy/equalisation.py:268-338).
"""
from __future__ import annotations

import numpy as np

__all__ = ["make_rx_chain", "pallas_eligibility"]


def pallas_eligibility(grid, methods, block_size=None, TrSyms=None):
    """Why (not) the hand-written block trainer: returns (ok, reasons).

    The rules mirror the kernel's preconditions: methods it implements,
    a decision grid it can evaluate for the decision-directed methods (an
    analytic square/cross/rectangular grid — ops/phase.detect_grid — or a
    general alphabet of at most ``MAX_GEN_POINTS`` points), and a
    power-of-two training block.
    """
    from qampy_tpu.ops.trainer_triton import (BLOCK_METHODS, MAX_GEN_POINTS,
                                              check_shapes)
    from qampy_tpu.ops.phase import grid_decision_info
    reasons = []
    bad = [m for m in methods if m not in BLOCK_METHODS]
    if bad:
        reasons.append("method(s) %s not implemented by the block trainer "
                       "kernel (%s)" % (bad, ", ".join(BLOCK_METHODS)))
    kind, p = grid_decision_info(grid)
    if any(m in ("sbd", "mddma", "dd") for m in methods) and (
            kind == "none" or (kind == "gen" and len(p[0]) > MAX_GEN_POINTS)):
        reasons.append("no kernel decision for this constellation")
    if block_size is not None:
        reasons.extend(check_shapes(TrSyms or block_size, block_size))
    return not reasons, tuple(reasons)


def split_collapsed_rows(w1):
    """CMA pol-demux singularity guard on dual-pol stage-1 taps.

    When the two tap rows converge onto the SAME source polarisation (rows
    nearly parallel in tap space), row 1 is re-initialised
    opposite-orthogonal to row 0 for stage 2 to retrain (the reference
    ships orthogonalizetaps for this, core/equalisation/
    equalisation.py:284-309, Liu et al. OFC'09). A traced select, no host
    round trip; taps of other mode counts pass through.
    """
    import jax.numpy as jnp
    if w1.shape[0] != 2:
        return w1
    f0 = w1[0].reshape(-1)
    f1 = w1[1].reshape(-1)
    inner = jnp.abs(jnp.vdot(f0, f1))
    n01 = jnp.sqrt(jnp.sum(jnp.abs(f0) ** 2) * jnp.sum(jnp.abs(f1) ** 2))
    orth = jnp.conj(w1[0][::-1, ::-1])[None]
    return jnp.where(inner > 0.9 * n01, jnp.concatenate([w1[:1], orth]), w1)


#: decimation strides a "decimated<k>" bps_mode accepts
_STRIDES = tuple(str(k) for k in range(2, 65))


def _decimation(bps_mode):
    """Stride of a ``"decimated<k>"`` mode (8 for plain "decimated")."""
    return int(bps_mode[len("decimated"):] or 8)


def make_rx_chain(M=64, Ntaps=17, os=2, methods=("mcma", "mddma"), mu=1.9e-3,
                  bps_angles=64, bps_N=14, block_size=256, TrSyms=None,
                  bps_mode="single", pallas=None, symbols=None):
    """Build a jittable ``forward(E) -> E_rec`` blind RX chain.

    Parameters mirror the granular API: ``M`` QAM order, ``Ntaps``/``mu``/
    ``methods``/``block_size`` the two-stage blind equaliser, ``TrSyms``
    the training prefix (None = train on the whole signal),
    ``bps_angles``/``bps_N`` the phase search. ``bps_mode``:

    * ``"single"`` — per-symbol blind phase search over one angle grid;
    * ``"twostage"``/``"twostage32"`` — coarse + fine grids (reference
      core/phaserecovery.py:222-288) with a wide coarse window;
    * ``"decimated"``/``"decimated<k>"`` — the whole search runs on every
      k-th equalised symbol (k=8 by default; the carrier phase is grossly
      oversampled at the symbol rate) and the per-symbol phase comes back
      as piecewise-linear interpolation of the unwrapped decimated phase.

    ``pallas`` selects the hand-written block trainer: None takes it where
    the platform has one and the configuration is eligible, False never,
    True insists (ValueError otherwise) — see ops/_backend.py.
    ``symbols`` overrides the constellation with an arbitrary host complex
    alphabet (geometric shaping, APSK, ...): decision-directed stages and
    the BPS then search that alphabet — the reference's any-M path
    (core/pythran_dsp.py:47-85). ``E`` is complex (nmodes, L) at ``os``
    samples/symbol; returns the equalised, derotated symbol sequence.
    """
    import jax
    import jax.numpy as jnp
    from qampy_tpu.ops import _backend
    from qampy_tpu.ops import equaliser as eqops
    from qampy_tpu.ops import phase as phops
    from qampy_tpu.theory import cal_symbols_qam, cal_scaling_factor_qam

    if not (bps_mode in ("single", "twostage", "twostage32")
            or (bps_mode.startswith("decimated")
                and bps_mode[len("decimated"):] in ("",) + _STRIDES)):
        raise ValueError("unknown bps_mode %r" % (bps_mode,))
    dtype = np.complex64
    if symbols is not None:
        const = np.asarray(symbols).astype(dtype).reshape(-1)
        M = const.shape[0]

        def _syms_for(method):
            # blind constants from the ALPHABET, not square-QAM M — the
            # modulus moments of a custom alphabet differ and CMA-family
            # stages would converge the output to the wrong scale
            row = eqops.generate_symbols_for_eq_from_alphabet(
                method, const, dtype)
            return np.tile(row, (2, 1)) if row.shape[0] == 1 else row

        symbols1 = _syms_for(methods[0])
        symbols2 = _syms_for(methods[1])
    else:
        symbols1 = eqops._reshape_symbols(None, methods[0], M, dtype, 2)
        symbols2 = eqops._reshape_symbols(None, methods[1], M, dtype, 2)
        const = (cal_symbols_qam(M) / np.sqrt(cal_scaling_factor_qam(M))).astype(dtype)
    grid = phops.detect_grid(const)
    kind = phops.grid_decision_info(grid)[0]
    angles_h = np.linspace(-np.pi / 4, np.pi / 4, bps_angles, endpoint=False,
                           dtype=np.float32)
    step_a, lo_a = float(np.pi / 2 / bps_angles), float(-np.pi / 4)
    # host-side (build-time) probes: for a general alphabet, a FITTED
    # uniform square grid gives an O(1) analytic decision in place of the
    # O(M) nearest-point search wherever it provably discriminates phase
    gen_grid_coarse = None
    gen_grid_fine = grid
    if (kind == "gen" and bps_mode != "single" and const.shape[0] > 24):
        # decimated mode runs ONE full search — probe the fitted grid at
        # the full angle count (the "fine" role); twostage probes at the
        # coarse count
        _div0 = (1 if bps_mode.startswith("decimated")
                 else (2 if bps_mode.endswith("32") else 4))
        _A0 = max(bps_angles // _div0, 16)
        gen_grid_coarse = phops.coarse_grid_for_alphabet(const,
                                                         Mtestangles=_A0)
        if gen_grid_coarse is not None and phops.fine_grid_ok(
                const, gen_grid_coarse, Mtestangles=_A0):
            gen_grid_fine = gen_grid_coarse
    ok, reasons = pallas_eligibility(grid, methods, block_size, TrSyms)
    use_kernel = _backend.use_kernel(pallas, reasons, what="rx chain")
    if use_kernel:
        from qampy_tpu.ops.trainer_triton import \
            train_equaliser_block_triton as train
    else:
        train = eqops.train_equaliser_block

    def _fwd(P, planes_out, wxy=None, return_taps=False):
        """One RX step: train stage-1/stage-2 taps, filter, BPS-derotate.

        ``P`` is the stacked (2*nmodes, L) [Re rows; Im rows] capture.
        Training runs on a TrSyms prefix, then the taps are frozen and
        applied to the whole signal. ``wxy`` skips BOTH trainings and
        demodulates with the given (nmodes, nmodes, Ntaps) taps — the
        warm-start (tracking) serving entry, the reference's ``wxinit=``
        discipline (qampy/equalisation.py:386-388); ``return_taps``
        additionally returns the frozen taps so the caller can feed them
        back."""
        nmodes = P.shape[0] // 2
        E = P[:nmodes] + 1j * P[nmodes:]
        if wxy is not None:
            w2 = jnp.asarray(wxy)
        else:
            trs = (P.shape[-1] - Ntaps) // os if TrSyms is None else TrSyms
            w0 = jnp.asarray(eqops._init_taps(Ntaps, nmodes, nmodes, dtype))
            _, w1, _ = train(E, trs, 1, os, mu, w0, symbols1, methods[0],
                             adaptive=True, block_size=block_size)
            w1 = split_collapsed_rows(w1)
            _, w2, _ = train(E, trs, 1, os, mu, w1, symbols2, methods[1],
                             adaptive=True, block_size=block_size)
        Eeq = eqops.apply_filter_to_signal(E, os, w2)
        if bps_mode.startswith("decimated"):
            # the whole search on every dec-th equalised symbol; the
            # decimated phase is unwrapped, then interpolated back to
            # the symbol rate block by block
            dec = _decimation(bps_mode)
            angles = jnp.asarray(angles_h).reshape(1, -1)
            idxd = jax.vmap(lambda e: phops.bps_idx(
                e, angles, const, bps_N, grid=gen_grid_fine))(Eeq[:, ::dec])
            phu = phops.unwrap_quarter(lo_a + step_a * idxd.astype(jnp.float32))
            # the tail block keeps the last slope at zero (clamped)
            slope = jnp.pad(phu[:, 1:] - phu[:, :-1], ((0, 0), (0, 1))) / dec
            ph = phops.interp_blocks(phu, slope, dec, Eeq.shape[-1])
            out = phops.derotate(Eeq, ph)
        elif bps_mode.startswith("twostage"):
            # wide coarse window (N1=60) against coarse-stage cycle slips;
            # the fine stage keeps bps_N for phase-tracking bandwidth
            div = 2 if bps_mode.endswith("32") else 4
            out, _ = phops.bps_twostage(Eeq, max(bps_angles // div, 16),
                                        const, bps_N, B=8, N1=60,
                                        grid=gen_grid_fine,
                                        grid_coarse=gen_grid_coarse)
        else:
            angles = jnp.asarray(angles_h).reshape(1, -1)
            idx = jax.vmap(lambda e: phops.bps_idx(e, angles, const, bps_N,
                                                   grid=grid))(Eeq)
            # the angle grid is affine: angle = lo + step*idx (no gather)
            ph = lo_a + step_a * idx.astype(jnp.float32)
            out = phops.derotate(Eeq, phops.unwrap_quarter(ph))
        res = (out.real, out.imag) if planes_out else out
        return (res, w2) if return_taps else res

    def _stack(P, Pi):
        if Pi is not None:
            P = jnp.concatenate([jnp.asarray(P), jnp.asarray(Pi)], axis=0)
        P = jnp.asarray(P)
        if jnp.iscomplexobj(P) or P.shape[0] % 2:
            raise ValueError(
                "planes entries take float32 stacked [Re rows; Im rows] "
                "(even row count), got %s %r" % (P.dtype, P.shape))
        return P

    def forward(E):
        """Complex (nmodes, L) capture in, recovered complex symbols out."""
        return _fwd(jnp.concatenate([E.real, E.imag], axis=0), False)

    def forward_planes(P, Pi=None):
        """Planes serving entry: ``P`` is the stacked (2*nmodes, L)
        float32 [Re rows; Im rows] capture, or pass a ``(pr, pi)`` plane
        pair as two arguments. Returns ``(outr, outi)`` float32 planes of
        the recovered symbols, equal to ``forward``'s."""
        return _fwd(_stack(P, Pi), True)

    def forward_with_taps(E):
        """``forward`` that also returns the frozen (nmodes, nmodes,
        Ntaps) taps — feed them to the tracking entries below."""
        return _fwd(jnp.concatenate([E.real, E.imag], axis=0), False,
                    return_taps=True)

    def forward_tracking(E, wxy):
        """Warm-start (tracking) serving entry: demodulate with taps from
        a previous dispatch, skipping BOTH blind trainings — the
        reference's ``wxinit=`` warm-start discipline
        (qampy/equalisation.py:386-388) as a zero-training-prefix blind
        serving mode (steady-state channel tracking happens through the
        periodic full dispatches that refresh the taps)."""
        return _fwd(jnp.concatenate([E.real, E.imag], axis=0), False,
                    wxy=wxy)

    def forward_planes_with_taps(P, Pi=None):
        """Planes twin of ``forward_with_taps``."""
        return _fwd(_stack(P, Pi), True, return_taps=True)

    def forward_tracking_planes(P, wxy, Pi=None):
        """Planes twin of ``forward_tracking``."""
        return _fwd(_stack(P, Pi), True, wxy=wxy)

    forward.planes = forward_planes
    forward.with_taps = forward_with_taps
    forward.tracking = forward_tracking
    forward.planes_with_taps = forward_planes_with_taps
    forward.tracking_planes = forward_tracking_planes
    # introspection: which kernel family the built chain actually takes
    forward.backend_info = {"family": (_backend.family() if use_kernel
                                       else "xla"),
                            "pallas": bool(use_kernel),
                            "grid_kind": kind, "reasons": reasons,
                            "bps_mode": bps_mode, "methods": tuple(methods),
                            "gen_bps_coarse": ("fitted" if gen_grid_coarse
                                               is not None else "exact"),
                            "gen_bps_fine": ("fitted" if gen_grid_fine
                                             is not grid else "exact")}
    return forward

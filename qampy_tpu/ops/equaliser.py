"""Adaptive MIMO equalisation: training kernels, error functions, filtering.

Parity: qampy/core/equalisation/{equalisation,pythran_equalisation}.py in the
reference. The reference's hot loop (pythran_equalisation.py:130-173) is a
strictly sequential per-symbol tap-update recurrence compiled to C++; here it
exists in two forms:

- ``backend="seq"``: an exact ``lax.scan`` over symbols with (taps, mu) carry
  — bit-comparable semantics to the reference, used for validation and for
  short trainings (frame sync, pilot sequences).
- ``backend="block"``: block-LMS — the training sequence is processed in
  blocks of S symbols with taps frozen within a block; the per-block filter
  output and the rank-S tap update are both matmuls.
  The adaptive-stepsize rule aggregates exactly (the update
  mu <- mu/(1+mu*e) chains as 1/mu += e over the sign-flip samples of the
  block). For small mu this converges like sample-LMS but takes S times
  fewer serial steps. ops/trainer_triton.py runs the same recurrence as
  one GPU kernel.

The filter application (reference pythran_equalisation.py:37-76, OpenMP
collapse(2)) is a strided complex convolution restructured as one batched
matmul over 128-sample windows (see apply_filter_to_signal).

All equaliser methods of the reference registry
(core/equalisation/equalisation.py:86-99) are implemented, including the
real-valued and data-aided variants.
"""
from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from qampy_tpu import helpers
from qampy_tpu.theory import cal_symbols_qam, cal_scaling_factor_qam

#: Decision based equalisation methods (reference core/equalisation/equalisation.py:87)
DECISION_BASED = ("sbd", "mddma", "dd", "sbd_data", "dd_real", "dd_data_real")
#: Non-decision based equalisation methods (:90)
NONDECISION_BASED = ("cma", "cma2", "mcma", "rde", "mrde", "cma_real", "sgncma_real", "sgncma")
#: Real-valued equalisation methods (:93)
REAL_VALUED = ("cma_real", "dd_real", "dd_data_real", "sgncma_real")
#: Data-aided equalisation methods (:96)
DATA_AIDED = ("dd_data_real", "sbd_data")
#: All available adaptive equaliser methods (:99)
TRAINING_FCTS = DECISION_BASED + NONDECISION_BASED
#: Extended blind methods from the reference's alternative backends: the
#: square-contour algorithm and the constellation-matched error (reference
#: cython_errorfcts.pyx:196-241, numba_equalisation.py:302-361); named as a
#: valid method in the reference driver docstring (equalisation.py:429).
EXTENDED_METHODS = ("sca", "cme")


# ---------------------------------------------------------------------------
# per-method training constants (host-side, static)
# ---------------------------------------------------------------------------

def _cal_Rconstant(M):
    """CMA radius constant (reference core/equalisation/equalisation.py:271-275)."""
    syms = cal_symbols_qam(M)
    syms = syms / np.sqrt(cal_scaling_factor_qam(M))
    return np.mean(abs(syms) ** 4) / np.mean(abs(syms) ** 2)


def _cal_Rconstant_complex(M):
    """MCMA complex radius constant (reference :277-281)."""
    syms = cal_symbols_qam(M)
    syms = syms / np.sqrt(cal_scaling_factor_qam(M))
    return (np.mean(syms.real ** 4) / np.mean(syms.real ** 2)
            + 1.j * np.mean(syms.imag ** 4) / np.mean(syms.imag ** 2))


def _cal_Rdash(syms):
    return ((abs(syms.real + syms.imag) + abs(syms.real - syms.imag))
            * (np.sign(syms.real + syms.imag) + np.sign(syms.real - syms.imag)
               + 1.j * (np.sign(syms.real + syms.imag) - np.sign(syms.real - syms.imag)))
            * syms.conj())


def _cal_Rsca(M):
    """SCA radius constant (reference :265-269)."""
    syms = cal_symbols_qam(M)
    syms = syms / np.sqrt(cal_scaling_factor_qam(M))
    Rd = _cal_Rdash(syms)
    return np.mean((abs(syms.real + syms.imag) + abs(syms.real - syms.imag)) ** 2 * Rd) / (4 * np.mean(Rd))


def generate_partition_codes_radius(M):
    """RDE partition codebook (reference :338-359): [codes, partition boundaries]."""
    syms = cal_symbols_qam(M)
    syms = syms / np.sqrt(cal_scaling_factor_qam(M))
    codes = np.unique(abs(syms) ** 4 / abs(syms) ** 2)
    parts = codes[:-1] + np.diff(codes) / 2
    return np.hstack([codes, parts])


def generate_partition_codes_complex(M):
    """MRDE complex partition codebook (reference :311-336)."""
    syms = cal_symbols_qam(M)
    syms = syms / np.sqrt(cal_scaling_factor_qam(M))
    syms_r = np.unique(abs(syms.real) ** 4 / abs(syms.real) ** 2)
    syms_i = np.unique(abs(syms.imag) ** 4 / abs(syms.imag) ** 2)
    codes = syms_r + 1.j * syms_i
    part_r = syms_r[:-1] + np.diff(syms_r) / 2
    part_i = syms_i[:-1] + np.diff(syms_i) / 2
    return np.hstack([codes, part_r + 1.j * part_i])


def _min_spacing(M):
    """Distance between constellation points along one dimension."""
    levels = np.unique(cal_symbols_qam(M).real / np.sqrt(cal_scaling_factor_qam(M)))
    return float(np.min(np.diff(levels)))


def generate_symbols_for_eq(method, M, dtype):
    """Per-method constants/symbol arrays (reference :101-136)."""
    if method in ("cma", "cma2", "sgncma"):
        return np.atleast_2d(_cal_Rconstant(M) + 0j).astype(dtype)
    if method == "sca":
        return np.atleast_2d(_cal_Rsca(M) + 0j).astype(dtype)
    if method == "cme":
        # row = [R, d, beta]: CMA radius, sinusoid period d chosen so the
        # grid penalty sin(pi*x/d) vanishes at every constellation level
        # (levels sit at odd multiples of half the spacing), and the CMA/sin
        # mixing ratio beta (He et al. 2004); override by passing
        # symbols=[[R, d, beta]] explicitly
        return np.atleast_2d(np.array(
            [_cal_Rconstant(M), _min_spacing(M) / 2, 0.5]) + 0j).astype(dtype)
    if method == "mcma":
        return np.atleast_2d(_cal_Rconstant_complex(M)).astype(dtype)
    if method == "rde":
        return np.atleast_2d(generate_partition_codes_radius(M) + 0j).astype(dtype)
    if method == "mrde":
        return np.atleast_2d(generate_partition_codes_complex(M)).astype(dtype)
    if method in ("sbd", "mddma", "dd"):
        return np.atleast_2d(cal_symbols_qam(M) / np.sqrt(cal_scaling_factor_qam(M))).astype(dtype)
    if method in ("sgncma_real", "cma_real"):
        return np.repeat([np.atleast_1d(_cal_Rconstant_complex(M).real.astype(dtype))], 2, axis=0)
    if method == "dd_real":
        symbols = cal_symbols_qam(M) / np.sqrt(cal_scaling_factor_qam(M))
        return np.vstack([symbols.real, symbols.imag]).astype(dtype)
    if method in DATA_AIDED:
        raise ValueError("%s is a data-aided method and needs the symbols to be passed" % method)
    raise ValueError("%s is unknown method" % method)


def generate_symbols_for_eq_from_alphabet(method, const, dtype):
    """Blind-method constants computed from an ARBITRARY alphabet.

    The reference derives CMA-family radius constants from the square-QAM
    order M (core/equalisation/equalisation.py:271-281); for a custom
    ``symbols=`` alphabet (geometric shaping, APSK) those moments must
    come from the alphabet itself — otherwise the modulus criterion
    converges the output to the WRONG SCALE and every downstream
    scale-sensitive decision breaks (measured: warped-256 rms 0.874 vs
    the alphabet's 1.0, SER ~1).
    """
    const = np.asarray(const).reshape(-1)
    if method in ("cma", "cma2", "sgncma"):
        R = np.mean(np.abs(const) ** 4) / np.mean(np.abs(const) ** 2)
        return np.atleast_2d(R + 0j).astype(dtype)
    if method == "mcma":
        R = (np.mean(const.real ** 4) / np.mean(const.real ** 2)
             + 1j * np.mean(const.imag ** 4) / np.mean(const.imag ** 2))
        return np.atleast_2d(R).astype(dtype)
    if method == "rde":
        # reference codebook layout (generate_partition_codes_radius):
        # [codes..., partition boundaries...] — codes are the |s|^4/|s|^2
        # moment radii per |s| shell, generalised to the alphabet's shells
        r2 = np.abs(const) ** 2
        shells = np.unique(np.round(r2, 6))
        codes = np.array([np.mean(r2[np.isclose(np.round(r2, 6), s)] ** 2)
                          / np.mean(r2[np.isclose(np.round(r2, 6), s)])
                          for s in shells])
        parts = codes[:-1] + np.diff(codes) / 2
        return np.atleast_2d(np.hstack([codes, parts]) + 0j).astype(dtype)
    if method == "mrde":
        # reference layout (generate_partition_codes_complex):
        # [codes..., partitions...] with per-axis |re|^4/|re|^2 radii
        sr = np.unique(np.round(np.abs(const.real) ** 4
                                / np.abs(const.real) ** 2, 9))
        si = np.unique(np.round(np.abs(const.imag) ** 4
                                / np.abs(const.imag) ** 2, 9))
        n = min(sr.size, si.size)
        sr, si = sr[:n], si[:n]
        codes = sr + 1j * si
        parts = (sr[:-1] + np.diff(sr) / 2) + 1j * (si[:-1] + np.diff(si) / 2)
        return np.atleast_2d(np.hstack([codes, parts])).astype(dtype)
    if method in ("sbd", "mddma", "dd"):
        return np.atleast_2d(const).astype(dtype)
    raise ValueError("no alphabet-derived constants for method %r" % method)


def _init_taps(Ntaps, nmodes, nmodes2, dtype):
    """Identity centre-tap initialisation (reference :364-373)."""
    wxy = np.zeros((nmodes, nmodes2, Ntaps), dtype=dtype)
    for i in range(nmodes):
        wxy[i, i, Ntaps // 2] = 1
    return wxy


def orthogonalizetaps(wx):
    """Y-pol taps orthogonal to X-pol to avoid the CMA singularity (reference :284-309)."""
    return np.conj(np.asarray(wx)[::-1, ::-1])


def _convert_sig_to_real(E):
    """Stack [Re; Im] into a 2*nmodes real signal (reference :253-257)."""
    E = jnp.asarray(E)
    return jnp.concatenate([E.real, E.imag], axis=0)


def _convert_sig_to_cmplx(E, modes):
    """Inverse of _convert_sig_to_real (reference :259-260)."""
    E = jnp.asarray(E)
    return E[:modes // 2, :] + 1j * E[modes // 2:, :]


# ---------------------------------------------------------------------------
# error functions — vectorised: operate on Xest of any shape
# ---------------------------------------------------------------------------
# Parity with reference pythran_equalisation.py:178-231 (complex) and
# :110-125 (real). ``syms`` is the per-mode symbol/constant row; ``i`` the
# (traced) training-symbol index used by data-aided methods.

def _partition_value(signal, partitions, codebook):
    """Radius partition lookup, vectorised (reference pythran_equalisation.py:4-9)."""
    idx = jnp.sum(signal[..., None] > partitions, axis=-1)
    return codebook[idx]


def _nearest(Xest, syms):
    """Per-element nearest-symbol decision via the expanded-distance matmul."""
    from qampy_tpu.core.metrics import decision_idx
    idx = decision_idx(Xest, syms)
    return syms[idx]


def _make_error_fn(method):
    """Return err_fn(Xest, syms, i) for a complex-valued method."""
    if method in ("cma", "sgncma"):
        # NOTE: the reference dispatch maps "sgncma" to the plain CMA error
        # (pythran_equalisation.py:133-134); matched deliberately.
        def fn(Xest, syms, i):
            d = syms[0].real - helpers.cabssquared(Xest)
            return d * Xest
    elif method == "cma2":
        def fn(Xest, syms, i):
            return (syms[0] - Xest ** 2) * Xest
    elif method == "mcma":
        def fn(Xest, syms, i):
            dr = syms[0].real - Xest.real ** 2
            di = syms[0].imag - Xest.imag ** 2
            return dr * Xest.real + 1j * (di * Xest.imag)
    elif method == "rde":
        def fn(Xest, syms, i):
            codebook, partition = jnp.array_split(syms, 2)
            sq = helpers.cabssquared(Xest)
            r = _partition_value(sq, partition.real, codebook.real)
            return Xest * (r - sq)
    elif method == "mrde":
        def fn(Xest, syms, i):
            codebook, partition = jnp.array_split(syms, 2)
            sqr = Xest.real ** 2
            sqi = Xest.imag ** 2
            rr = _partition_value(sqr, partition.real, codebook.real)
            ri = _partition_value(sqi, partition.imag, codebook.imag)
            return (rr - sqr) * Xest.real + 1j * ((ri - sqi) * Xest.imag)
    elif method == "sbd":
        def fn(Xest, syms, i):
            s = _nearest(Xest, syms)
            return ((s.real - Xest.real) * jnp.abs(s.real)
                    + 1j * (s.imag - Xest.imag) * jnp.abs(s.imag))
    elif method == "sbd_data":
        def fn(Xest, syms, i):
            s = syms[i]
            d = s - Xest
            return d.real * jnp.abs(s.real) + 1j * (d.imag * jnp.abs(s.imag))
    elif method == "mddma":
        def fn(Xest, syms, i):
            s = _nearest(Xest, syms)
            return ((s.real ** 2 - Xest.real ** 2) * Xest.real
                    + 1j * (s.imag ** 2 - Xest.imag ** 2) * Xest.imag)
    elif method == "dd":
        def fn(Xest, syms, i):
            return _nearest(Xest, syms) - Xest
    elif method == "sca":
        # square-contour algorithm (reference cython_errorfcts.pyx:196-226):
        # drive whichever I/Q component is larger towards the square contour
        # of radius R; both when exactly equal
        def fn(Xest, syms, i):
            # _cal_Rsca returns the squared contour radius (same convention
            # as _cal_Rconstant: an E|s|^4/E|s|^2-style ratio)
            R2 = syms[0].real
            ar, ai = jnp.abs(Xest.real), jnp.abs(Xest.imag)
            A = (ar >= ai).astype(Xest.real.dtype)
            B = (ai >= ar).astype(Xest.real.dtype)
            return (16 * Xest.real * (R2 - Xest.real ** 2) * A
                    + 1j * (16 * Xest.imag * (R2 - Xest.imag ** 2) * B))
    elif method == "cme":
        # constellation-matched error (reference cython_errorfcts.pyx:228-241,
        # numba_equalisation.py:302-329): CMA term plus a sinusoidal
        # constellation-grid penalty of period d mixed in with ratio beta
        def fn(Xest, syms, i):
            R, d, beta = syms[0].real, syms[1].real, syms[2].real
            err = (R - helpers.cabssquared(Xest)) * Xest
            k = beta * jnp.pi / (2 * d)
            return err + k * (jnp.sin(Xest.real * jnp.pi / d)
                              + 1j * jnp.sin(Xest.imag * jnp.pi / d))
    else:
        raise ValueError("Unknown method %s" % method)
    return fn


def _make_error_fn_real(method):
    """Return err_fn(Xest, syms, i) for a real-valued method (reference :110-125)."""
    if method == "cma":
        def fn(Xest, syms, i):
            return (syms[0] - Xest ** 2) * Xest
    elif method == "sgncma":
        def fn(Xest, syms, i):
            return jnp.sign(syms[0] - Xest ** 2) * jnp.sign(Xest)
    elif method == "dd":
        def fn(Xest, syms, i):
            s = _nearest(Xest, syms)
            return (s - Xest) * jnp.abs(s)
    elif method == "dd_data":
        def fn(Xest, syms, i):
            s = syms[i]
            return (s - Xest) * jnp.abs(s)
    else:
        raise ValueError("Unknown method %s" % method)
    return fn


# ---------------------------------------------------------------------------
# sequential trainer — exact reference recurrence as lax.scan
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnames=("TrSyms", "Niter", "os", "method", "adaptive", "real_valued"))
def train_equaliser_seq(E, TrSyms, Niter, os, mu, wx, symbols, method,
                        adaptive=False, real_valued=False):
    """Exact sequential LMS training (reference pythran_equalisation.py:130-173).

    E: (nmodes, L); wx: (nout, nmodes, ntaps); symbols: (nout, Nsym).
    Returns (err (nout, TrSyms*Niter), wx, mu_per_mode).
    Every output mode trains independently (vmapped), mirroring the OpenMP
    parallel-for over modes.
    """
    E = jnp.asarray(E)
    wx = jnp.asarray(wx)
    symbols = jnp.asarray(symbols)
    nmodes = E.shape[0]
    ntaps = wx.shape[-1]
    errfn = _make_error_fn_real(method) if real_valued else _make_error_fn(method)
    conj = (lambda x: x) if real_valued else jnp.conj
    rdtype = E.real.dtype
    mu0 = jnp.asarray(mu, dtype=rdtype)

    def train_one_mode(w0, syms_row):
        def step(carry, i):
            w, mu_c, err_p = carry
            tr = jnp.mod(i, TrSyms)
            X = lax.dynamic_slice(E, (0, tr * os), (nmodes, ntaps))
            Xest = jnp.sum(w * X)
            err = errfn(Xest, syms_row, tr)
            w = w + mu_c * err * conj(X)
            if adaptive:
                # reference calls adapt_step(mu, err[i], err[i-1]) whose body
                # shrinks by the *second* argument — the PREVIOUS error
                # (pythran_equalisation.py:12-22,171)
                if real_valued:
                    keep = err * err_p > 0
                    e2 = err_p * err_p
                else:
                    keep = (err.real * err_p.real > 0) & (err.imag * err_p.imag > 0)
                    e2 = err_p.real ** 2 + err_p.imag ** 2
                mu_new = jnp.where(keep, mu_c, mu_c / (1 + mu_c * e2))
                mu_c = jnp.where(tr > 0, mu_new, mu_c)
            return (w, mu_c, err), err

        steps = jnp.arange(Niter * TrSyms)
        carry0 = (_vary_like(w0, E), _vary_like(mu0, E),
                  _vary_like(jnp.zeros((), dtype=E.dtype), E))
        # unrolling amortises per-step scan overhead; the recurrence itself
        # is unchanged
        (w, mu_f, _), errs = lax.scan(step, carry0, steps, unroll=8)
        return errs, w, mu_f

    errs, wout, mus = jax.vmap(train_one_mode)(wx, symbols)
    return errs, wout, mus


# ---------------------------------------------------------------------------
# block trainer — block-LMS as per-block matmuls
# ---------------------------------------------------------------------------

def training_windows(E, Ts, os, ntaps):
    """Pre-gathered training windows ``Xw[t*nmodes + m, s] = E[m, s*os + t]``
    for ``s < Ts`` (tap-major rows): os strided phase planes of the
    training prefix, then ntaps contiguous slices of them. ``E`` is
    zero-padded when shorter than the last window's reach."""
    nmodes = E.shape[0]
    W = Ts * os + ntaps
    pre = lax.slice(jnp.pad(E, ((0, 0), (0, max(0, W - E.shape[-1])))),
                    (0, 0), (nmodes, W))
    ph = [lax.slice(pre, (0, p), (nmodes, W - ((W - p) % os)), (1, os))
          for p in range(os)]
    cols = [lax.slice(ph[t % os], (0, t // os), (nmodes, t // os + Ts))
            for t in range(ntaps)]
    return jnp.concatenate(cols, axis=0)


def _vary_like(x, E):
    """Give x the shard_map varying-axes type of data derived from E.

    Inside shard_map the scan carries (taps, stepsize, last error) become
    device-varying; adding a zero derived from E propagates that type
    without changing values. Outside shard_map XLA folds this away.
    """
    z = (E[(0,) * E.ndim] * 0).real
    return x + z.astype(x.real.dtype)


@partial(jax.jit, static_argnames=("TrSyms", "Niter", "os", "method", "adaptive",
                                   "real_valued", "block_size"))
def train_equaliser_block(E, TrSyms, Niter, os, mu, wx, symbols, method,
                          adaptive=False, real_valued=False, block_size=32):
    """Block-LMS training: matmul-formulated variant of the reference recurrence.

    Splits the TrSyms training symbols into blocks of ``block_size``; within a
    block the taps are frozen so the filter output for all output modes is one
    (S, nmodes*ntaps) x (nmodes*ntaps, nout) matmul and the tap update is the
    transposed rank-S matmul. The adaptive step size aggregates the
    reference's rule exactly over each block (1/mu accumulates the squared
    error of every sign-flip sample).

    Same signature/returns as train_equaliser_seq; err is per-block-expanded
    to (nout, nblocks*Niter*S) which equals TrSyms*Niter when divisible.
    """
    E = jnp.asarray(E)
    wx = jnp.asarray(wx)
    symbols = jnp.asarray(symbols)
    nmodes = E.shape[0]
    nout = wx.shape[0]
    ntaps = wx.shape[-1]
    S = min(block_size, TrSyms)
    nblocks = TrSyms // S
    errfn = _make_error_fn_real(method) if real_valued else _make_error_fn(method)
    conj = (lambda x: x) if real_valued else jnp.conj
    rdtype = E.real.dtype
    mu0 = jnp.full((nout,), mu, dtype=rdtype)

    # all training windows gathered once (a per-step fancy-index gather
    # would sit on the serial path of every block step)
    Xw = training_windows(E, nblocks * S, os, ntaps)  # (ntaps*nmodes, Ts)

    def step(carry, b):
        w, mu_c, err_p = carry  # w: (nout, ntaps, nmodes) tap-major, mu_c: (nout,)
        blk = jnp.mod(b, nblocks)
        Xf = lax.dynamic_slice(Xw, (0, blk * S),
                               (ntaps * nmodes, S))  # (K, S) contiguous
        Wf = w.reshape(nout, ntaps * nmodes)
        Xest = jnp.matmul(Wf, Xf, precision=lax.Precision.HIGHEST)  # (nout, S)
        tr0 = blk * S
        idxs = tr0 + jnp.arange(S)
        err = jax.vmap(lambda xrow, srow: errfn(xrow, srow, idxs))(Xest, symbols)  # (nout, S)
        dW = jnp.matmul(err * mu_c[:, None].astype(err.dtype), conj(Xf).T,
                        precision=lax.Precision.HIGHEST)  # (nout, ntaps*nmodes)
        w = w + dW.reshape(nout, ntaps, nmodes)
        if adaptive:
            eall = jnp.concatenate([err_p[:, None], err], axis=1)
            # the reference shrink uses the PREVIOUS error's magnitude
            # (adapt_step(mu, err[i], err[i-1]), pythran_equalisation.py:12-22)
            # and skips the first sample of each pass (i > 0 gate, :171)
            prev = eall[:, :-1]
            if real_valued:
                flip = ~(eall[:, 1:] * prev > 0)
                e2 = prev * prev
            else:
                flip = ~((eall[:, 1:].real * prev.real > 0)
                         & (eall[:, 1:].imag * prev.imag > 0))
                e2 = prev.real ** 2 + prev.imag ** 2
            flip = flip & (idxs[None, :] > 0)
            # chained mu <- mu/(1+mu*e) == 1/mu += e over flip samples
            inv = 1.0 / mu_c + jnp.sum(jnp.where(flip, e2.real, 0.), axis=1)
            mu_c = 1.0 / inv
        return (w, mu_c, err[:, -1]), err

    steps = jnp.arange(Niter * nblocks)
    err_p0 = jnp.zeros((nout,), dtype=E.dtype)
    w0 = jnp.moveaxis(wx, -1, 1)  # (nout, ntaps, nmodes) to match Xw rows
    carry0 = (_vary_like(w0, E), _vary_like(mu0, E), _vary_like(err_p0, E))
    (w, mu_f, _), errs = lax.scan(step, carry0, steps, unroll=4)
    errs = jnp.moveaxis(errs, 0, 1).reshape(nout, -1)
    return errs, jnp.moveaxis(w, 1, -1), mu_f


# ---------------------------------------------------------------------------
# filter application — strided complex convolution as a batched matmul
# ---------------------------------------------------------------------------

#: matmul precision for the filter contraction: full float32. On the GPU,
#: Precision.HIGH lets XLA run the dot in TF32 (10-bit mantissa, ~1e-3
#: relative error per product); the filter is memory-bound, so exact
#: float32 costs little (PERF.md, precision findings).
_FILTER_PRECISION = lax.Precision.HIGHEST


@partial(jax.jit, static_argnames=("os", "precision"))
def apply_filter_to_signal(E, os, wx, precision=None):
    """Apply equaliser taps and downsample by os.

    Parity: reference pythran_equalisation.py:37-76 —
    ``out[j, i] = sum_{k,t} E[k, i*os+t] * wx[j, k, t]`` (cross-correlation).

    Formulation (grouped-shift im2col): write the output index as
    i = c*G + g and bake the G in-group shifts into the weight matrix —
    W2[(q,g),(p,tau)] = Wcat[q,p,tau-g*os].  One real matmul then computes
    all taps x modes x re/im planes x G shifts:

        out2[(q,g), c] = sum_{p,tau} W2[(q,g),(p,tau)] * planes[p, c*G*os+tau]

    With G = 128 // nplanes_out the matmul has 128 rows,
    K = nplanes*((G-1)*os+ntaps), and the im2col operand A2 is built from
    plain reshapes + one minor-dim transpose (no strided slices and no
    ntaps-fold shifted-copy blowup in device memory: it moves ~2x the
    signal). ``precision`` defaults to ``_FILTER_PRECISION``.
    """
    E = jnp.asarray(E)
    wx = jnp.asarray(wx)
    os = int(os)
    nmodes, L = E.shape
    nout, _, ntaps = wx.shape
    Lout = (L - ntaps) // os + 1
    cplx = jnp.iscomplexobj(E)
    if cplx:
        planes = jnp.concatenate([E.real, E.imag], axis=0)
        Wr = wx.real.reshape(nout, nmodes * ntaps)
        Wi = wx.imag.reshape(nout, nmodes * ntaps)
        Wcat = jnp.concatenate([jnp.concatenate([Wr, -Wi], 1),
                                jnp.concatenate([Wi, Wr], 1)], 0)
    else:
        planes = E
        Wcat = wx.reshape(nout, nmodes * ntaps)
    P = planes.shape[0]
    nop = Wcat.shape[0]
    # windows-batched fast path: when a group size G exists with
    # (G-1)*os+ntaps <= 128 and G*os | 128, the im2col operand is never
    # materialised — 128-wide windows every G*os samples come from nshift
    # tile-aligned shifted reshapes and one batched dot_general contracts
    # the window axis (no minor-dim transposes of signal-sized arrays)
    Gw = 0
    for g in range(min(128 // nop, (128 - ntaps) // os + 1), 0, -1):
        if 128 % (g * os) == 0:
            Gw = g
            break
    if Gw > 1:
        return _apply_filter_windows(planes, Wcat, os, Gw, Lout, nout, cplx,
                                     E.dtype, precision or _FILTER_PRECISION)
    G = max(1, 128 // nop)
    Gos = G * os
    TAU = (G - 1) * os + ntaps
    Ncols = -(-Lout // G)
    nb = -(-TAU // Gos)  # shifted reshape blocks needed to cover TAU rows
    padL = (Ncols + nb - 1) * Gos
    planes = jnp.pad(planes, ((0, 0), (0, max(0, padL - L))))
    # A2[(p,tau), c] = planes[p, c*Gos + tau], built blockwise: block b holds
    # rows tau in [b*Gos, (b+1)*Gos) as a (Ncols, Gos) reshape transposed on
    # its two minor dims (unit-stride reads, one relayout pass)
    blocks = [
        planes[:, b * Gos: (b + Ncols) * Gos]
        .reshape(P, Ncols, Gos).swapaxes(1, 2)
        for b in range(nb)
    ]
    A2 = jnp.concatenate(blocks, axis=1)[:, :TAU, :].reshape(P * TAU, Ncols)
    # W2: stack the G output-phase shifts of Wcat along tau
    Wcat3 = Wcat.reshape(nop, P, ntaps)
    W2 = jnp.stack([jnp.pad(Wcat3, ((0, 0), (0, 0), (g * os, TAU - ntaps - g * os)))
                    for g in range(G)], axis=1).reshape(nop * G, P * TAU)
    out2 = jnp.matmul(W2.astype(A2.dtype), A2,
                      precision=precision or _FILTER_PRECISION)
    out = out2.reshape(nop, G, Ncols).swapaxes(1, 2).reshape(nop, Ncols * G)[:, :Lout]
    if cplx:
        return (out[:nout] + 1j * out[nout:]).astype(E.dtype)
    return out.astype(E.dtype)


def _apply_filter_windows(planes, Wcat, os, G, Lout, nout, cplx, dtype,
                          precision=_FILTER_PRECISION):
    """Windows-batched filter: out2[(o,g), c] = sum_{p,j} W2[p,(o,g),j] *
    planes[p, c*G*os + j] with the G output phases baked into shifted weight
    rows (W2[p,(o,g),j] = Wcat[o,p,j-g*os]). The window operand W3 is built
    from 128/(G*os) shifted reshapes of the signal — no strided slices, no
    minor-dim transposes of signal-sized arrays.
    """
    P, L = planes.shape
    nop = Wcat.shape[0]
    ntaps = Wcat.shape[1] // P
    Gos = G * os
    nshift = 128 // Gos
    C = -(-Lout // G)            # number of windows
    Q = -(-C // nshift)          # 128-aligned window groups
    padL = Q * 128 + 128
    planes = jnp.pad(planes, ((0, 0), (0, max(0, padL - L))))
    # W3[p, q*nshift + r, j] = planes[p, q*128 + r*Gos + j]
    parts = [
        lax.slice(planes, (0, r * Gos), (P, r * Gos + Q * 128))
        .reshape(P, Q, 128)
        for r in range(nshift)
    ]
    W3 = jnp.stack(parts, axis=2).reshape(P, Q * nshift, 128)
    # W2[p, o*G+g, j] = Wcat[o, p, j - g*os] (roll never wraps taps:
    # g*os + ntaps <= 128 by construction of G)
    Wcat3 = Wcat.reshape(nop, P, ntaps)
    Wpad = jnp.pad(Wcat3, ((0, 0), (0, 0), (0, 128 - ntaps)))
    W2 = jnp.stack([jnp.roll(Wpad, g * os, axis=-1) for g in range(G)],
                   axis=1).reshape(nop * G, P, 128).swapaxes(0, 1)
    res = lax.dot_general(W2.astype(planes.dtype), W3,
                          dimension_numbers=(((2,), (2,)), ((0,), (0,))),
                          precision=precision)  # (P, M, C')
    out2 = jnp.sum(res, axis=0)  # (M, C')
    out = out2.reshape(nop, G, -1).swapaxes(1, 2).reshape(nop, -1)[:, :Lout]
    if cplx:
        return (out[:nout] + 1j * out[nout:]).astype(dtype)
    return out.astype(dtype)


def apply_filter(E, os, wxy, modes=None, method=None):
    """Driver-level apply_filter (reference core/equalisation/equalisation.py:138-188).

    Handles the complex-signal/real-valued-taps conversion. ``method`` is
    accepted for API compatibility and ignored (single backend).
    """
    E = jnp.asarray(E)
    wxy = jnp.asarray(wxy)
    if modes is None:
        modes = np.arange(wxy.shape[0])
    else:
        modes = np.atleast_1d(np.asarray(modes))
    nmodes = modes.shape[0]
    if jnp.iscomplexobj(E) and jnp.iscomplexobj(wxy):
        return apply_filter_to_signal(E, os, wxy[modes])
    if jnp.iscomplexobj(E):
        E = _convert_sig_to_real(E)
    out = apply_filter_to_signal(E, os, wxy[modes])
    return _convert_sig_to_cmplx(out, nmodes)


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------

def _cal_training_symbol_len(os, ntaps, L):
    """Default training length (reference :361-362)."""
    return int(L // os // ntaps - 1) * int(ntaps)


def _reshape_symbols(symbols, method, M, dtype, nmodes):
    """Normalise the shape of the symbols/constants array (reference :568-594)."""
    if method in EXTENDED_METHODS:
        # sca takes one constant, cme a [R, d, beta] row; anything else
        # (e.g. the constellation a signal-level wrapper passes by default)
        # is replaced by the generated constants
        nconst = {"sca": 1, "cme": 3}[method]
        if symbols is None or np.asarray(symbols).shape[-1] != nconst:
            symbols = generate_symbols_for_eq(method, M, dtype)
    elif symbols is None or method in NONDECISION_BASED:
        symbols = generate_symbols_for_eq(method, M, dtype)
    symbols = np.asarray(symbols)
    if method not in REAL_VALUED:
        if symbols.ndim == 1 or symbols.shape[0] == 1:
            symbols = np.tile(symbols, (nmodes, 1))
        elif symbols.shape[0] != nmodes:
            raise ValueError(
                "Symbols array is shape {} but signal has {} modes".format(symbols.shape, nmodes))
        return np.atleast_2d(symbols.astype(dtype))
    if np.iscomplexobj(symbols):
        if symbols.ndim == 1 or symbols.shape[0] == 1:
            symbols = np.repeat([symbols.real, symbols.imag], nmodes // 2, axis=0).squeeze()
            symbols = symbols.reshape(nmodes, -1)
        elif symbols.shape[0] == nmodes // 2:
            symbols = np.vstack([symbols.real, symbols.imag])
        else:
            raise ValueError(
                "Complex symbols array has {} modes, needs 1 or {}".format(symbols.shape[0], nmodes // 2))
    else:
        if symbols.shape[0] == 2 and nmodes > 2:
            symbols = np.repeat([symbols[0], symbols[1]], nmodes // 2, axis=0).squeeze()
            symbols = symbols.reshape(nmodes, -1)
        elif symbols.shape[0] != nmodes:
            raise ValueError(
                "Symbols array is shape {} but signal has {} modes".format(symbols.shape, nmodes))
    return symbols.astype(dtype)


def _resolve_backend(backend, block_size):
    """Resolve ``backend="auto"``/``block_size=None`` for the current device.

    "auto" picks the exact sequential scan on CPU (bit-exact vs the
    reference, and the scan is fast there) and the block-LMS trainer on
    an accelerator — mirroring the reference's philosophy of defaulting to
    its fastest backend (pythran); ops/_backend.py decides which.
    ``block_size=None`` resolves to 32 for the scan-exact regime and 128
    on an accelerator (the fused chain's block scale). Explicit values
    always win.
    """
    from qampy_tpu.ops._backend import exact_trainer_default
    exact = exact_trainer_default()
    if backend == "auto":
        backend = "seq" if exact else "block"
    if block_size is None:
        block_size = 128 if (backend == "block" and not exact) else 32
    return backend, block_size


def equalise_signal(E, os, mu, M, wxy=None, Ntaps=None, TrSyms=None, Niter=1,
                    method="mcma", adaptive_stepsize=False, symbols=None, modes=None,
                    apply=False, backend="auto", block_size=None,
                    avoid_cma_sing=False, **kwargs):
    """Blind/data-aided adaptive equalisation of a (nmodes, L) signal.

    Parity: reference core/equalisation/equalisation.py:468-566.
    ``backend`` selects the exact sequential scan ("seq"), the
    block-LMS ("block"), or "auto" (the default):
    seq on CPU, block on an accelerator — see ``_resolve_backend``.
    ``avoid_cma_sing`` (dual-pol only) trains mode 0 first and
    initialises mode 1 opposite-orthogonal to it (``orthogonalizetaps``,
    Liu et al. OFC'09) before training mode 1 — the newer reference
    releases expose the same kwarg (the checked-in reference ships the
    helper unwired; its notebooks call the kwarg).
    Returns (wxy, err) or (Eest, wxy, err) when apply=True.
    """
    method = method.lower()
    backend, block_size = _resolve_backend(backend, block_size)
    if avoid_cma_sing:
        E_arr = jnp.asarray(E)
        if E_arr.shape[0] != 2 or method in REAL_VALUED:
            raise ValueError("avoid_cma_sing needs a dual-pol complex signal")
        if modes is not None:
            raise ValueError("avoid_cma_sing trains both modes; do not pass modes=")
        w0, err0 = equalise_signal(E_arr, os, mu, M, wxy=wxy, Ntaps=Ntaps,
                                   TrSyms=TrSyms, Niter=Niter, method=method,
                                   adaptive_stepsize=adaptive_stepsize,
                                   symbols=symbols, modes=[0], apply=False,
                                   backend=backend, block_size=block_size,
                                   **kwargs)
        w_init = jnp.asarray(w0).at[1].set(
            jnp.asarray(orthogonalizetaps(np.asarray(w0[0]))))
        w1, err1 = equalise_signal(E_arr, os, mu, M, wxy=np.asarray(w_init),
                                   Ntaps=Ntaps, TrSyms=TrSyms, Niter=Niter,
                                   method=method,
                                   adaptive_stepsize=adaptive_stepsize,
                                   symbols=symbols, modes=[1], apply=False,
                                   backend=backend, block_size=block_size,
                                   **kwargs)
        err = jnp.stack([jnp.asarray(err0)[0], jnp.asarray(err1)[1]])
        if apply:
            Eest = apply_filter(E_arr, os, w1)
            return Eest, w1, err
        return w1, err
    E = jnp.asarray(E)
    real_valued = method in REAL_VALUED
    if real_valued:
        E = _convert_sig_to_real(E)
    nmodes = E.shape[0]
    if modes is None:
        modes = np.arange(nmodes)
    else:
        modes = np.atleast_1d(np.asarray(modes))
        if real_valued:
            modes = np.hstack([modes, modes + nmodes // 2])
        assert np.max(modes) < nmodes, "largest mode number is larger than shape of signal"
    if wxy is None:
        wxy = _init_taps(Ntaps, nmodes, nmodes, np.dtype(E.dtype))
    else:
        wxy = np.asarray(wxy).astype(E.dtype)
        Ntaps = wxy.shape[-1]
        assert wxy.ndim == 3, "wxy needs to be three dimensional"
    if TrSyms is None:
        TrSyms = _cal_training_symbol_len(os, Ntaps, E.shape[-1])
    TrSyms = int(TrSyms)
    symbols = _reshape_symbols(symbols, method, M, np.dtype(E.dtype), nmodes)
    kern_method = method[:-5] if real_valued else method
    if backend == "block":
        train = train_equaliser_block
    elif backend == "seq":
        train = train_equaliser_seq
    else:
        raise ValueError("unknown equaliser backend %r" % (backend,))
    kern_kwargs = dict(adaptive=bool(adaptive_stepsize), real_valued=real_valued)
    if backend == "block":
        kern_kwargs["block_size"] = block_size
    # train only the requested modes; untouched rows of wxy pass through
    wsel = jnp.asarray(wxy)[modes]
    ssel = jnp.asarray(symbols)[modes]
    err_sel, wsel_out, mu_out = train(E, TrSyms, int(Niter), int(os),
                                      float(mu), wsel, ssel, kern_method, **kern_kwargs)
    if np.array_equal(modes, np.arange(nmodes)):
        wxy = wsel_out
        err = err_sel
    else:
        wxy = jnp.asarray(wxy).at[modes].set(wsel_out)
        err = jnp.zeros((nmodes, err_sel.shape[-1]), dtype=err_sel.dtype).at[modes].set(err_sel)
    if apply:
        Eest = apply_filter(E, os, wxy, modes=modes)
        return Eest, wxy, err
    return wxy, err


def dual_mode_equalisation(E, os, mu, M, wxy=None, Ntaps=None, TrSyms=(None, None),
                           Niter=(1, 1), methods=("mcma", "sbd"),
                           adaptive_stepsize=(False, False), symbols=None, modes=None,
                           apply=True, backend="auto",
                           avoid_cma_sing=(False, False), **kwargs):
    """Two-stage equalisation: stage-1 taps warm-start stage 2.

    Parity: reference core/equalisation/equalisation.py:400-466;
    ``avoid_cma_sing`` per stage as in the newer reference releases (see
    equalise_signal).
    """
    symbols = np.atleast_1d(symbols) if symbols is not None else None
    if symbols is not None and symbols.ndim < 3:
        symbols = np.tile(symbols, (2, 1, 1))
    s0 = symbols[0] if symbols is not None else None
    s1 = symbols[1] if symbols is not None else None
    wxy1, err1 = equalise_signal(E, os, mu[0], M, wxy=wxy, Ntaps=Ntaps, TrSyms=TrSyms[0],
                                 Niter=Niter[0], method=methods[0],
                                 adaptive_stepsize=adaptive_stepsize[0], symbols=s0,
                                 modes=modes, backend=backend,
                                 avoid_cma_sing=avoid_cma_sing[0], **kwargs)
    wxy2, err2 = equalise_signal(E, os, mu[1], M, wxy=wxy1, TrSyms=TrSyms[1],
                                 Niter=Niter[1], method=methods[1],
                                 adaptive_stepsize=adaptive_stepsize[1], symbols=s1,
                                 modes=modes, backend=backend,
                                 avoid_cma_sing=avoid_cma_sing[1], **kwargs)
    if apply:
        Eest = apply_filter(E, os, wxy2, modes=modes)
        return Eest, wxy2, (err1, err2)
    return wxy2, (err1, err2)


def CDcomp(E, fs, N, L, D, wl):
    """Chromatic dispersion compensation, overlap-add blockwise FFT.

    Parity: reference core/equalisation/equalisation.py:596-669.
    Returns (compensated signal, frequency response H).
    """
    E = jnp.asarray(E).flatten()
    samp = E.shape[0]
    c = 2.99792458e8
    if N == 0:
        N = samp
    omega = jnp.pi * fs * jnp.linspace(-1, 1, N)
    beta2 = D * wl ** 2 / (c * 2 * np.pi)
    H = jnp.exp(-.5j * omega ** 2 * beta2 * L)
    if N == samp:
        sigEQ = jnp.fft.fftshift(jnp.fft.fft(E))
        sigEQ = sigEQ * H
        sigEQ = jnp.fft.ifft(jnp.fft.ifftshift(sigEQ))
    else:
        n = N // 2
        zp = N // 4
        B = samp // n
        # blocks of n samples zero-padded into N, filtered, overlap-added
        blocks = E[: B * n].reshape(B, n)
        sigB = jnp.zeros((B, N), dtype=jnp.complex64 if E.dtype == jnp.complex64 else jnp.complex128)
        sigB = sigB.at[:, zp:-zp].set(blocks)
        sigB = jnp.fft.ifft(jnp.fft.fft(sigB, axis=-1) * H, axis=-1)
        sigEQ = jnp.zeros(n * (B + 1), dtype=sigB.dtype)
        for i in range(B):
            sigEQ = sigEQ.at[i * n: i * n + n + 2 * zp].add(sigB[i])
        sigEQ = sigEQ[zp:-zp]
    return sigEQ, H


# Reference keeps a pure-python apply_filter variant (core/equalisation/
# equalisation.py apply_filter_py); here there is one backend only.
apply_filter_py = apply_filter

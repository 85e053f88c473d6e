"""Filter functions: matched filtering, pulse shaping, analog filter emulation.

Parity: qampy/core/filter.py in the reference. FFT filters use jnp.fft; the
IIR (bessel/butter) filters are designed host-side with scipy (static
coefficients) and applied with a ``lax.scan`` over biquad sections, which is
the exact sequential sosfilt recurrence. ``pre_filter_wdm`` fixes the
undefined-variable bug in the reference (core/filter.py:75).
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
import scipy.signal as scisig

from qampy_tpu.core.special import rrcos_freq, rrcos_time


def fftconvolve_same(sig, h):
    """Linear convolution along the last axis, 'same' output length.

    Equivalent to scipy.signal.fftconvolve(sig, h, 'same') per mode.
    """
    sig = jnp.asarray(sig)
    h = jnp.asarray(h)
    n = sig.shape[-1]
    m = h.shape[-1]
    nfull = n + m - 1
    nfft = int(2 ** np.ceil(np.log2(nfull)))
    cdtype = jnp.result_type(sig.dtype, h.dtype, jnp.complex64)
    S = jnp.fft.fft(sig.astype(cdtype), nfft)
    H = jnp.fft.fft(h.astype(cdtype), nfft)
    full = jnp.fft.ifft(S * H)[..., :nfull]
    start = (m - 1) // 2
    out = full[..., start:start + n]
    if not (jnp.iscomplexobj(sig) or jnp.iscomplexobj(h)):
        out = out.real
    return out.astype(sig.dtype) if jnp.iscomplexobj(sig) else out.astype(sig.dtype)


def pre_filter(signal, bw):
    """Brick-wall low-pass pre-filter (reference core/filter.py:28-49)."""
    sig = jnp.atleast_2d(jnp.asarray(signal))
    N = sig.shape
    h = np.zeros(N[1], dtype=np.asarray(sig.real).dtype)
    cut = int(N[1] / (bw / 2))
    h[cut:-cut] = 1
    s = jnp.fft.ifft(jnp.fft.ifftshift(
        jnp.fft.fftshift(jnp.fft.fft(sig, axis=-1), axes=-1) * h, axes=-1), axis=-1)
    if jnp.asarray(signal).ndim < 2:
        return s.flatten()
    return s


def pre_filter_wdm(signal, bw, os, center_freq=0):
    """Ideal LP filter selecting part of the spectrum (reference core/filter.py:51-84).

    The reference implementation references an undefined variable (``sig``,
    core/filter.py:75); this is the intended behaviour.
    """
    signal = jnp.asarray(signal)
    N = signal.shape[-1]
    freq_axis = jnp.fft.fftfreq(N, 1 / os)
    h = (jnp.abs(freq_axis - center_freq) < bw / 2).astype(signal.real.dtype)
    return jnp.fft.ifft(jnp.fft.fft(signal, axis=-1) * h, axis=-1)


#: sample count above which the IIR paths switch from the sequential
#: lax.scan recurrence to the parallel-prefix (associative scan) form —
#: the scan runs O(N) dependent steps (serving-hostile at 2^20 samples),
#: the prefix form O(log N) full-width passes over tiny (state x state)
#: matrices.
IIR_ASSOC_MIN_SAMPLES = 4096
#: the prefix form materialises (N, n, n) transition products; beyond
#: this state dimension the memory trade stops paying and the exact scan
#: is kept (with a performance warning at serving sizes).
IIR_ASSOC_MAX_STATE = 4


def _affine_prefix_states(M, bs):
    """All states of ``s[k] = M @ s[k-1] + bs[k]`` (``s[-1] = 0``) via
    ``lax.associative_scan`` — the affine maps ``x -> M x + b`` compose
    associatively (``(A2, b2) o (A1, b1) = (A2 A1, A2 b1 + b2)``), so the
    O(N) sequential IIR recurrence becomes O(log N) parallel passes.
    Exact in exact arithmetic (no truncation); ``M`` is the static
    (n, n) transition matrix and ``bs`` the (N, n, modes) per-step
    offsets. Returns (N, n, modes) states.

    Layout: the n x n transition products are carried as n^2 SEPARATE
    (N,) planes with the combine unrolled to scalar arithmetic — a
    batched (N, n, n) matmul carry of tiny matrices wastes the vector
    width on padding; the plane form keeps every pass full-width."""
    N, n, modes = bs.shape
    dt = bs.dtype
    A0 = tuple(jnp.full((N,), M[i, j], dtype=dt)
               for i in range(n) for j in range(n))
    b0 = tuple(bs[:, i, :] for i in range(n))            # each (N, modes)

    def comb(x, y):
        A1, b1 = x
        A2, b2 = y
        A = tuple(
            sum(A2[i * n + k] * A1[k * n + j] for k in range(n))
            for i in range(n) for j in range(n))
        b = tuple(
            sum(A2[i * n + k][:, None] * b1[k] for k in range(n)) + b2[i]
            for i in range(n))
        return A, b

    _, S = jax.lax.associative_scan(comb, (A0, b0))
    return jnp.stack(S, axis=1)


def _sosfilt_assoc(sos, x):
    """Parallel-prefix sosfilt: same DF2T recurrence as ``_sosfilt_scan``
    but each biquad section's state sequence comes from
    ``_affine_prefix_states`` (z' = M z + c x with
    M = [[-a1, 1], [-a2, 0]], c = [b1 - a1 b0, b2 - a2 b0];
    y = b0 x + z[0]). Sections compose sequentially (nsec passes)."""
    x = jnp.asarray(x)
    sos = np.asarray(sos, dtype=np.float64)
    rdt = x.real.dtype
    xcur = x.T                                    # (N, modes)
    nmodes = xcur.shape[1]
    for s in range(sos.shape[0]):
        b0, b1, b2, _, a1, a2 = sos[s]
        M = jnp.asarray(np.array([[-a1, 1.0], [-a2, 0.0]]), dtype=rdt)
        c = jnp.asarray(np.array([b1 - a1 * b0, b2 - a2 * b0]), dtype=rdt)
        bs = c[None, :, None] * xcur[:, None, :]  # (N, 2, modes)
        S = _affine_prefix_states(M, bs)          # S[k] = z after step k
        z0 = jnp.concatenate(
            [jnp.zeros((1, nmodes), S.dtype), S[:-1, 0]], axis=0)
        xcur = rdt.type(b0) * xcur + z0
    return xcur.T


def _sosfilt_scan(sos, x):
    """Sequential second-order-section IIR filtering via lax.scan.

    x: (modes, N) real or complex. sos: (nsec, 6) static numpy coefficients.
    Implements the direct-form-II-transposed recurrence exactly like
    scipy.signal.sosfilt.
    """
    x = jnp.asarray(x)
    sos = np.asarray(sos, dtype=np.float64)
    nsec = sos.shape[0]
    dt = x.dtype
    b = jnp.asarray(sos[:, :3], dtype=x.real.dtype)
    a = jnp.asarray(sos[:, 3:], dtype=x.real.dtype)

    def step(carry, xn):
        z = carry  # (nsec, 2, modes)
        xcur = xn
        zs = []
        for s in range(nsec):
            y = b[s, 0] * xcur + z[s, 0]
            z0 = b[s, 1] * xcur - a[s, 1] * y + z[s, 1]
            z1 = b[s, 2] * xcur - a[s, 2] * y
            zs.append(jnp.stack([z0, z1]))
            xcur = y
        return jnp.stack(zs), xcur

    z0 = jnp.zeros((nsec, 2, x.shape[0]), dtype=dt)
    _, y = jax.lax.scan(step, z0, x.T)
    return y.T


def filter_signal(signal, fs, cutoff, ftype="bessel", order=2, analog=False):
    """Apply an analog-emulation filter (bessel/butter/gauss/exp).

    Parity: reference core/filter.py:86-147, including ``analog=True``
    (continuous-time lsim simulation, see ``_lsim_scan``) and the default
    digital (sos) path.
    """
    sig = jnp.atleast_2d(jnp.asarray(signal))
    if ftype == "gauss":
        f = jnp.linspace(-fs / 2, fs / 2, sig.shape[1], endpoint=False)
        w = cutoff / (2 * np.sqrt(2 * np.log(2)))
        g = jnp.exp(-f ** 2 / (2 * w ** 2)).astype(sig.real.dtype)
        fsig = jnp.fft.fftshift(jnp.fft.fft(jnp.fft.fftshift(sig, axes=-1), axis=-1), axes=-1) * g
        out = jnp.fft.fftshift(jnp.fft.ifft(jnp.fft.fftshift(fsig, axes=-1), axis=-1), axes=-1)
        return out.flatten() if jnp.asarray(signal).ndim == 1 else out
    if ftype == "exp":
        f = jnp.linspace(-fs / 2, fs / 2, sig.shape[1], endpoint=False)
        w = cutoff / (np.sqrt(2 * np.log(2) ** 2))
        g = jnp.exp(-jnp.sqrt(f ** 2 / (2 * w ** 2)))
        g = (g / g.max()).astype(sig.real.dtype)
        fsig = jnp.fft.fftshift(jnp.fft.fft(jnp.fft.fftshift(sig, axes=-1), axis=-1), axes=-1) * g
        out = jnp.fft.fftshift(jnp.fft.ifft(jnp.fft.fftshift(fsig, axes=-1), axis=-1), axes=-1)
        return out.flatten() if jnp.asarray(signal).ndim == 1 else out
    if analog:
        # continuous-time (lsim) path, reference core/filter.py:110-140:
        # analog prototype at Wn = cutoff*2*pi simulated at the sample rate.
        # The reference calls scipy.signal.lsim per mode; here the same
        # first-order-hold discretisation (lsim's interp=True model) is
        # computed host-side via the Van Loan augmented matrix exponential
        # and the recurrence runs as one vmapped lax.scan. Element-wise
        # equal to scipy lsim for real signals (test_filter); for COMPLEX
        # signals the reference/scipy path silently casts to real
        # (ComplexWarning in scipy _ltisys.py, discarding the Q component)
        # — here the linear system is applied to the full complex signal,
        # which is the physically meant behaviour (documented deviation).
        Wn = cutoff * 2 * np.pi
        if ftype == "bessel":
            b, a = scisig.bessel(order, Wn, 'low', norm='mag', analog=True,
                                 output='ba')
        elif ftype == "butter":
            b, a = scisig.butter(order, Wn, 'low', analog=True, output='ba')
        else:
            raise ValueError("unknown analog filter type %s" % ftype)
        out = _lsim_scan(b, a, sig, fs)
        return out.flatten() if jnp.asarray(signal).ndim == 1 else out
    if ftype == "bessel":
        sos = scisig.bessel(order, cutoff, 'low', norm='mag', analog=False, output='sos', fs=fs)
    elif ftype == "butter":
        sos = scisig.butter(order, cutoff, 'low', analog=False, output='sos', fs=fs)
    else:
        raise ValueError("unknown filter type %s" % ftype)
    if sig.shape[-1] >= IIR_ASSOC_MIN_SAMPLES:
        out = _sosfilt_assoc(sos, sig)
    else:
        out = _sosfilt_scan(sos, sig)
    return out.flatten() if jnp.asarray(signal).ndim == 1 else out


def _lsim_scan(b, a, sig, fs):
    """Continuous-time LTI simulation with first-order-hold input.

    Equivalent of ``scipy.signal.lsim((b, a), u, t)`` with uniform
    ``t = arange(N)/fs`` (reference core/filter.py:131-137): the transfer
    function goes to state space host-side, the FOH discretisation
    (Ad, Bd0, Bd1) comes from one augmented matrix exponential
    (Van Loan 1978), and ``x[k+1] = Ad x[k] + Bd0 u[k] + Bd1 u[k+1]``,
    ``y[k] = C x[k] + D u[k]`` runs as a lax.scan vmapped over modes.
    """
    from scipy.linalg import expm
    A, B, C, D = scisig.tf2ss(b, a)
    n = A.shape[0]
    dt = 1.0 / fs
    # Van Loan blocks: expm([[A, B, 0], [0, 0, I], [0, 0, 0]] * dt) has
    # top rows [e^{A dt}, H0, H1*dt] with H0 = int_0^dt e^{A(dt-s)} B ds
    # (zoh response) and H1 = int_0^dt e^{A(dt-s)} B (s/dt) ds (ramp)
    M = np.zeros((n + 2, n + 2))
    M[:n, :n] = A * dt
    M[:n, n:n + 1] = B * dt
    M[n, n + 1] = dt
    F = expm(M)
    Ad = F[:n, :n]
    H0 = F[:n, n]
    H1 = F[:n, n + 1] / dt
    Bd0 = H0 - H1
    Bd1 = H1
    cdt = np.complex128 if sig.dtype in (jnp.complex64, jnp.complex128) \
        else np.float64
    if not jax.config.jax_enable_x64:
        cdt = np.complex64 if cdt == np.complex128 else np.float32
    Ad, Bd0, Bd1 = (x.astype(sig.real.dtype) for x in (Ad, Bd0, Bd1))
    Cr = C[0].astype(sig.real.dtype)
    Dr = np.asarray(D).reshape(-1)[0].astype(sig.real.dtype)

    sig_c = sig.astype(cdt)
    N = sig_c.shape[-1]
    if N >= IIR_ASSOC_MIN_SAMPLES and n <= IIR_ASSOC_MAX_STATE:
        # parallel-prefix form: x[k+1] = Ad x[k] + (Bd0 u[k] + Bd1 u[k+1])
        # is affine with constant Ad — O(log N) passes instead of N
        # dependent scan steps (exact recurrence, no truncation)
        u = sig_c.T                                   # (N, modes)
        bs = (jnp.asarray(Bd0)[None, :, None] * u[:-1, None, :]
              + jnp.asarray(Bd1)[None, :, None] * u[1:, None, :])
        S = _affine_prefix_states(jnp.asarray(Ad), bs)   # (N-1, n, modes)
        xs = jnp.concatenate(
            [jnp.zeros((1, n, u.shape[1]), S.dtype), S], axis=0)
        y = jnp.einsum('i,nim->nm', jnp.asarray(Cr), xs) + Dr * u
        return y.T
    if N >= IIR_ASSOC_MIN_SAMPLES:
        import warnings
        warnings.warn(
            "filter_signal(analog=True) with filter order %d falls back "
            "to the sequential per-sample scan (parallel-prefix path is "
            "bounded at state dim %d); expect O(N) serial time at %d "
            "samples" % (n, IIR_ASSOC_MAX_STATE, N), stacklevel=2)

    def run_mode(u):
        def step(x, uk):
            u0, u1 = uk
            y = jnp.sum(Cr * x) + Dr * u0
            x1 = (Ad @ x) + Bd0 * u0 + Bd1 * u1
            return x1, y
        x0 = jnp.zeros((n,), dtype=cdt)
        u_pairs = (u[:-1], u[1:])
        _, y = jax.lax.scan(step, x0, u_pairs)
        y_last = jnp.sum(Cr * _) + Dr * u[-1]
        return jnp.concatenate([y, y_last[None]])

    return jax.vmap(run_mode)(sig_c)


def _rrcos_pulseshaping_freq(sig, fs, T, beta):
    """RRC filter applied in the spectral domain (reference core/filter.py:149-175)."""
    sig = jnp.asarray(sig)
    f = jnp.fft.fftfreq(sig.shape[-1]) * fs
    nyq_fil = rrcos_freq(f, beta, T)
    nyq_fil = nyq_fil / nyq_fil.max()
    sig_f = jnp.fft.fft(sig, axis=-1)
    return jnp.fft.ifft(sig_f * nyq_fil.astype(sig_f.real.dtype), axis=-1)


def rrcos_pulseshaping(sig, fs, T, beta, taps=1001):
    """RRC filter in the time domain via FFT convolution (reference core/filter.py:177-212)."""
    sig = jnp.asarray(sig)
    if taps is None:
        return _rrcos_pulseshaping_freq(sig, fs, T, beta)
    t = np.linspace(0, taps, taps, endpoint=False)
    t -= t[(t.size - 1) // 2]
    t /= fs
    nqt = rrcos_time(jnp.asarray(t), beta, T)
    nqt = (nqt / nqt.max()).astype(sig.real.dtype)
    return fftconvolve_same(sig, nqt)


def moving_average(sig, N=3):
    """Moving average of length N (valid region), via cumsum.

    Parity: reference core/filter.py:215-237; output length len(sig)-N+1.
    """
    sig = jnp.asarray(sig)
    sign = jnp.atleast_2d(sig)
    z = jnp.zeros(sign.shape[:-1] + (1,), dtype=sign.dtype)
    ret = jnp.cumsum(jnp.concatenate([z, sign], axis=-1), axis=-1)
    out = (ret[..., N:] - ret[..., :-N]) / N
    if sig.ndim == 1:
        return out.flatten()
    return out

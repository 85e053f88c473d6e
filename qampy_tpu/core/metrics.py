"""Signal quality metrics: decisions, SNR, EVM, LLRs, GMI and MI.

Parity: qampy/core/signal_quality.py and the metric kernels in
qampy/core/pythran_dsp.py (estimate_snr :244-286, soft_l_value_demapper
:95-131, cal_gmi_mc :181-197, cal_mi_mc :289-313). The reference implements
these as OpenMP loops; here each one is a single vectorised XLA computation:

- decisions use the expanded-distance matmul form
  ``|E - s|^2 = |E|^2 - 2 Re(E conj(s)) + |s|^2`` so the inner product is
  a matmul,
- ``estimate_snr`` uses segment reductions keyed by the tx symbol index
  instead of per-symbol boolean masks,
- the soft demapper is a batched logsumexp over the bitmap tensor.
"""
from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from qampy_tpu.helpers import cabssquared
from qampy_tpu.theory import cal_symbols_qam, cal_scaling_factor_qam


def _neg2re_cross(E, symbols):
    """-2*Re(E conj(s)) + |s|^2 for all pairs, via a real matmul.

    E: (..., N) complex; symbols: (M,) complex. Returns (..., N, M) real.
    The |E|^2 term is omitted — it does not change argmin over symbols.
    """
    Er = jnp.stack([E.real, E.imag], axis=-1)  # (..., N, 2)
    S = jnp.stack([symbols.real, symbols.imag], axis=0)  # (2, M)
    cross = jnp.matmul(Er, S.astype(Er.dtype), precision=jax.lax.Precision.HIGHEST)
    return cabssquared(symbols).astype(Er.dtype) - 2 * cross


@partial(jax.jit, static_argnames=())
def decision_idx(E, symbols):
    """Index of the nearest constellation point for every sample.

    E: (..., N); symbols: (M,). Returns int32 (..., N).
    """
    d = _neg2re_cross(E, symbols)
    return jnp.argmin(d, axis=-1).astype(jnp.int32)


def make_decision(E, symbols):
    """Nearest-symbol decision (reference pythran_equalisation.py:306-334).

    Returns (decided_symbols, distances, indices) exactly like the reference
    kernel; works on 1D or ND inputs along the last axis.
    """
    E = jnp.asarray(E)
    symbols = jnp.asarray(symbols)
    idx = decision_idx(E, symbols)
    det = symbols[idx]
    dist = jnp.abs(E - det)
    return det, dist, idx


def det_symbol(X, symbs):
    """Single-sample decision operator (reference pythran_equalisation.py:240-265).

    Returns (symbol, squared distance).
    """
    X = jnp.asarray(X)
    symbs = jnp.asarray(symbs)
    d = cabssquared(X - symbs)
    j = jnp.argmin(d)
    return symbs[j], d[j]


def generate_bitmapping_mtx(coded_symbs, coded_bits, M, dtype=np.complex64):
    """Bit-to-symbol map used by the soft demapper (reference core/signal_quality.py:298-305).

    Returns (num_bits, M/2, 2): bit_map[b, :, v] are the constellation points
    whose bit b equals v.
    """
    coded_symbs = np.asarray(coded_symbs)
    num_bits = int(np.log2(M))
    out_mtx = np.reshape(np.asarray(coded_bits), (M, num_bits))
    bit_map = np.zeros([num_bits, int(M / 2), 2], dtype=dtype)
    for bit in range(num_bits):
        bit_map[bit, :, 0] = coded_symbs[~out_mtx[:, bit]]
        bit_map[bit, :, 1] = coded_symbs[out_mtx[:, bit]]
    return bit_map


@jax.jit
def estimate_snr(signal_rx, symbols_tx, gray_symbols):
    """Data-aided SNR estimation from per-constellation-point cluster statistics.

    Parity: reference pythran_dsp.py:244-286. The reference masks the signal
    per constellation point in an OpenMP loop; here the tx symbols are mapped
    to segment ids (exact nearest-point match since tx symbols are noiseless)
    and segment sums produce all cluster statistics at once.

    Returns (snr, S0, N0) in linear units.
    """
    signal_rx = jnp.asarray(signal_rx)
    symbols_tx = jnp.asarray(symbols_tx)
    gray_symbols = jnp.asarray(gray_symbols)
    M = gray_symbols.shape[0]
    L = signal_rx.shape[0]
    seg = decision_idx(symbols_tx, gray_symbols)
    ones = jnp.ones(L, dtype=signal_rx.real.dtype)
    K = jax.ops.segment_sum(ones, seg, num_segments=M)
    s1 = jax.ops.segment_sum(signal_rx, seg, num_segments=M)
    s2 = jax.ops.segment_sum(cabssquared(signal_rx), seg, num_segments=M)
    Ksafe = jnp.maximum(K, 1)
    mu = s1 / Ksafe
    # sum |x - mu|^2 = sum|x|^2 - K |mu|^2
    var = (s2 - Ksafe * cabssquared(mu)) / Ksafe
    Px = K / L
    N0 = jnp.sum(var * Px)
    S0 = jnp.sum(cabssquared(mu) * Px)
    return S0 / N0, S0, N0


def _llr_dists(rx_symbs, bits_map, snr):
    """-snr * |bmap - rx|^2 for all (sample, bit, k, v) combinations."""
    rx = jnp.asarray(rx_symbs)
    bmap = jnp.asarray(bits_map)
    nb, k, _ = bmap.shape
    flat = bmap.reshape(-1)
    d = _neg2re_cross(rx, flat) + cabssquared(rx)[..., None].astype(rx.real.dtype)
    return -snr * d.reshape(rx.shape + (nb, k, 2))


def _demap_chunked(fn, rx_symbs, bits_map, chunk=2 ** 16):
    """Bound the (N, nb, M/2, 2) distance tensor by chunking over samples.

    At serving sizes the full tensor is ~1.5 GB f32 for 64-QAM at 2^20
    symbols; a lax.map over ``chunk``-sample blocks keeps the live
    intermediate at chunk*nb*M bytes with identical results (the demap is
    elementwise over samples).
    """
    rx = jnp.asarray(rx_symbs).reshape(-1)
    n = rx.shape[0]
    nb = jnp.asarray(bits_map).shape[0]
    if n <= chunk:
        return fn(rx)
    pad = (-n) % chunk
    blocks = jnp.pad(rx, (0, pad)).reshape(-1, chunk)
    out = jax.lax.map(fn, blocks)
    return out.reshape(-1, nb)[:n]


@partial(jax.jit, static_argnames=())
def soft_l_value_demapper(rx_symbs, snr, bits_map):
    """Exact log-sum-exp soft LLR demapper (reference pythran_dsp.py:95-104).

    rx_symbs: (N,) complex; bits_map: (num_bits, M/2, 2).
    Returns (N, num_bits) L-values: log p(bit=1) - log p(bit=0).
    Large inputs are processed in 2^16-sample chunks (the distance tensor
    is N*num_bits*M floats — ~1.5 GB at 64-QAM/2^20 unchunked).
    """
    def one(rx):
        e = _llr_dists(rx, bits_map, snr)
        ls = jax.scipy.special.logsumexp(e, axis=-2)  # (N, nb, 2)
        return (ls[..., 1] - ls[..., 0]).astype(
            jnp.result_type(jnp.asarray(rx).real.dtype, jnp.float32))
    return _demap_chunked(one, rx_symbs, bits_map)


@partial(jax.jit, static_argnames=())
def soft_l_value_demapper_minmax(rx_symbs, snr, bits_map):
    """Min-max approximate LLR demapper (reference pythran_dsp.py:119-131).

    Uses the same expanded-square matmul cross-term distances as the exact
    sibling (f32 matmul output instead of a broadcast complex difference —
    half the device memory) and the same 2^16-sample chunking.
    """
    def one(rx):
        d = -_llr_dists(rx, bits_map, snr) / snr   # squared distances
        dmin = jnp.min(d, axis=-2)                 # (N, nb, 2)
        return (snr * (dmin[..., 0] - dmin[..., 1])).astype(
            jnp.result_type(jnp.asarray(rx).real.dtype, jnp.float32))
    return _demap_chunked(one, rx_symbs, bits_map)


def norm_to_s0(sig, M):
    """Normalise signal to the blind S0 power estimate (reference core/signal_quality.py:122-139)."""
    return jnp.asarray(sig) / jnp.sqrt(cal_s0(sig, M))


def _cal_gamma(M):
    """Gamma factor for the blind SNR estimator (reference core/signal_quality.py:227-231).

    The reference is also called with non-constellation M (partition_16qam
    passes M=1.32, core/phaserecovery.py:319): there qampy's
    ``cal_symbols_qam`` degenerates to a single normalised point so the
    formula collapses to gamma = 1/M — accidental but load-bearing (1/1.32
    is the Muller-Mello ring constant). Reproduce that explicitly instead
    of dividing by a zero scaling factor.
    """
    f = float(M)
    if not (f.is_integer() and f >= 4 and np.log2(f).is_integer()):
        return 1.0 / f
    A = np.abs(cal_symbols_qam(M)) / np.sqrt(cal_scaling_factor_qam(M))
    uniq, counts = np.unique(A, return_counts=True)
    return np.sum(uniq ** 4 * counts / M)


def cal_snr_qam(E, M):
    """Blind moment-based SNR estimate after Gao & Tepedelenlioglu.

    Parity: reference core/signal_quality.py:196-224.
    """
    E = jnp.asarray(E)
    gamma = _cal_gamma(M)
    r2 = jnp.mean(cabssquared(E))
    r4 = jnp.mean(cabssquared(E) ** 2)
    S1 = 1 - 2 * r2 ** 2 / r4 - jnp.sqrt((2 - gamma) * (2 * r2 ** 4 / r4 ** 2 - r2 ** 2 / r4))
    S2 = gamma * r2 ** 2 / r4 - 1
    return S1 / S2


def cal_s0(E, M):
    """Blind signal power estimate S0 (reference core/signal_quality.py:234-258)."""
    E = jnp.asarray(E)
    gamma = _cal_gamma(M)
    r2 = jnp.mean(cabssquared(E))
    r4 = jnp.mean(cabssquared(E) ** 2)
    S1 = 1 - 2 * r2 ** 2 / r4 - jnp.sqrt((2 - gamma) * (2 * r2 ** 4 / r4 ** 2 - r2 ** 2 / r4))
    S2 = gamma * r2 ** 2 / r4 - 1
    return r2 / (1 + S2 / S1)


def cal_snr_blind_qpsk(E):
    """Blind QPSK SNR from 4th-power constellation variance (reference core/signal_quality.py:261-271)."""
    E = jnp.asarray(E)
    E4 = -E ** 4
    Eref = E4 ** (1. / 4)
    P = jnp.mean(cabssquared(Eref))
    var = jnp.var(Eref)
    return 10 * jnp.log10(P / jnp.abs(var))


def _cal_evm_blind(sig, M):
    """Blind EVM (reference core/signal_quality.py:142-164)."""
    ideal = jnp.asarray(cal_symbols_qam(M).flatten())
    Pi = norm_to_s0(ideal, M)
    Pm = norm_to_s0(jnp.asarray(sig), M)
    d = jnp.min((Pm[:, None].real - Pi.real) ** 2 + (Pm[:, None].imag - Pi.imag) ** 2, axis=1)
    evm = jnp.mean(d) / jnp.mean(cabssquared(Pi))
    return jnp.sqrt(evm)


def cal_evm(sig, M, known=None):
    """Linear EVM of an M-QAM signal (reference core/signal_quality.py:167-193)."""
    if known is None:
        return _cal_evm_blind(sig, M)
    Pi = norm_to_s0(jnp.asarray(known), M)
    Ps = norm_to_s0(jnp.asarray(sig), M)
    evm = jnp.mean((Pi.real - Ps.real) ** 2 + (Pi.imag - Ps.imag) ** 2)
    return jnp.sqrt(evm / jnp.mean(cabssquared(Pi)))


def cal_ser_qam(data_rx, symbol_tx, M):
    """Symbol error rate against known symbols (reference core/signal_quality.py:274-296)."""
    symbols = jnp.asarray(cal_symbols_qam(M) / np.sqrt(cal_scaling_factor_qam(M)))
    det, _, _ = make_decision(jnp.asarray(data_rx), symbols)
    return jnp.count_nonzero(det - jnp.asarray(symbol_tx)) / data_rx.shape[-1]


@jax.jit
def cal_mi_mc(noise, symbols, N0):
    """Monte-Carlo mutual information from noise realisations.

    Parity: reference pythran_dsp.py:289-300 — triple loop collapsed into one
    broadcasted computation over (M, L, M).
    """
    noise = jnp.asarray(noise)
    symbols = jnp.asarray(symbols)
    M = symbols.shape[0]
    noise = noise.reshape(-1)
    diff = symbols[:, None] - symbols[None, :]  # (M_i, M_j)
    # exp(-(|d_ij|^2 + 2 Re(d_ij * z_l)) / N0), sum over j
    ex = -(cabssquared(diff)[:, None, :] +
           2 * (diff[:, None, :] * noise[None, :, None]).real) / N0
    tmp = jnp.sum(jnp.exp(ex), axis=-1)  # (M, L)
    return np.log2(M) - jnp.mean(jnp.log2(tmp))


@jax.jit
def cal_mi_mc_fast(sig, sig_tx, symbols, N0):
    """Fast MC mutual information using rx/tx pairs (reference pythran_dsp.py:302-313)."""
    sig = jnp.asarray(sig)
    sig_tx = jnp.asarray(sig_tx)
    symbols = jnp.asarray(symbols)
    M = symbols.shape[0]
    d = cabssquared(sig[..., None] - symbols)
    d0 = cabssquared(sig - sig_tx)
    tmp = jnp.sum(jnp.exp(-(d - d0[..., None]) / N0), axis=-1)
    return np.log2(M) - jnp.mean(jnp.log2(tmp))


def cal_mi(signal, symbols_tx, alphabet, N0, fast=True):
    """Mutual information of a noisy signal (reference core/signal_quality.py:307-336)."""
    if fast:
        return cal_mi_mc_fast(signal, symbols_tx, alphabet, N0)
    noise = jnp.asarray(signal) - jnp.asarray(symbols_tx)
    return cal_mi_mc(noise, alphabet, N0)


def cal_gmi_mc(symbols, snr, ns, bit_map, seed=0):
    """Monte-Carlo GMI of a bit-mapped constellation (reference pythran_dsp.py:181-197).

    The reference's 4-deep OpenMP loop is one broadcasted jnp computation over
    (nbits, 2, M/2, ns).
    """
    symbols = jnp.asarray(symbols)
    bit_map = jnp.asarray(bit_map)
    M = symbols.shape[0]
    nbits = int(np.log2(M))
    key = jax.random.PRNGKey(seed)
    k1, k2 = jax.random.split(key)
    z = jnp.sqrt(1 / snr) * (jax.random.normal(k1, (ns,)) +
                             1j * jax.random.normal(k2, (ns,))) / np.sqrt(2)
    return _cal_gmi_mc_jit(symbols, bit_map, z, snr, nbits)


@partial(jax.jit, static_argnames=("nbits",))
def _cal_gmi_mc_jit(symbols, bit_map, z, snr, nbits):
    M = symbols.shape[0]
    ns = z.shape[0]

    def exp_sum(d):
        # d: (..., M', ) differences sym - alphabet; returns sum over the
        # alphabet of exp(-snr*(2 Re(z*d) + |d|^2)) for every noise draw.
        ex = -snr * (2 * (d[..., None] * z).real + cabssquared(d)[..., None])
        return jnp.sum(jnp.exp(ex), axis=-2)  # (..., ns)

    bm = jnp.moveaxis(bit_map[:nbits], -1, 1)  # (nbits, 2, M/2)
    d_all = bm[..., None] - symbols[None, None, None, :]      # (nb, 2, M/2, M)
    d_sub = bm[:, :, :, None] - bm[:, :, None, :]             # (nb, 2, M/2, M/2)
    nom = exp_sum(d_all)    # (nb, 2, M/2, ns)
    denom = exp_sum(d_sub)  # (nb, 2, M/2, ns)
    gmi_sum = jnp.sum(jnp.log2(nom / denom))
    return nbits - gmi_sum / (M * ns)

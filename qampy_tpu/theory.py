"""Analytic properties of communication signals and constellation construction.

Parity: qampy/theory.py in the reference. Constellation construction is
host-side numpy (one-time static constants that get baked into jit programs);
the analytic SER/BER/GMI curves are jnp and jittable.
"""
from __future__ import annotations

import numpy as np
import jax.numpy as jnp
from jax.scipy.special import erfc

from qampy_tpu.utils import bin2gray
from qampy_tpu.helpers import dB2lin


def q_function(x):
    """Tail probability of the standard normal distribution (reference core/special_fcts.py:206-215)."""
    return 0.5 * erfc(jnp.asarray(x) / np.sqrt(2))


def ser_vs_es_over_n0_qam(snr, M):
    """SER of an M-QAM signal vs Es/N0 in linear units, valid for M > 4.

    Parity: reference theory.py:34-39.
    """
    snr = jnp.asarray(snr)
    e = erfc(jnp.sqrt(3 * snr / (2 * (M - 1))))
    return 2 * (1 - 1 / np.sqrt(M)) * e - (1 - 2 / np.sqrt(M) + 1 / M) * e ** 2


def ber_vs_evm_qam(evm_dB, M):
    """BER of an M-QAM signal as a function of EVM in dB (reference theory.py:41-69)."""
    L = np.sqrt(M)
    evm = dB2lin(evm_dB)
    return 2 * (1 - 1 / L) / np.log2(L) * q_function(
        jnp.sqrt(3 * np.log2(L) / (L ** 2 - 1) * (2 / (evm * np.log2(M)))))


def ber_vs_es_over_n0_qam(snr, M):
    """BER vs SNR (linear) for M-QAM (reference theory.py:72-97)."""
    L = np.sqrt(M)
    snr = jnp.asarray(snr)
    return 2 * (1 - 1 / L) / np.log2(L) * q_function(
        jnp.sqrt(3 * np.log2(L) / (L ** 2 - 1) * (2 * snr / np.log2(M))))


def ser_vs_es_over_n0_psk(snr, M):
    """SER of an M-PSK signal vs Es/N0 in linear units (reference theory.py:99-102)."""
    return erfc(jnp.sqrt(jnp.asarray(snr)) * np.sin(np.pi / M))


def ser_vs_es_over_n0_4pam(snr):
    """SER of a 4-PAM signal vs Es/N0 in linear units (reference theory.py:105-108)."""
    return 0.75 * erfc(jnp.sqrt(jnp.asarray(snr) / 5))


def cal_symbols_qam(M):
    """Constellation points for M-QAM (square or cross, reference theory.py:111-118)."""
    if np.log2(M) % 2 > 0.5:
        return cal_symbols_cross_qam(M)
    return cal_symbols_square_qam(M)


def cal_symbols_square_qam(M):
    """Square M-QAM constellation (reference theory.py:151-158)."""
    L = int(np.sqrt(M))
    side = np.linspace(-(L - 1), L - 1, L)
    re, im = np.meshgrid(side, side, indexing="ij")
    return (re + 1.j * im).flatten()


def cal_symbols_cross_qam(M):
    """Non-square (cross) M-QAM constellation (reference theory.py:161-178)."""
    N = (np.log2(M) - 1) / 2
    s = 2 ** (N - 1)
    nr = int(2 ** (N + 1))
    ni = int(2 ** N)
    re = np.linspace(-(nr - 1), nr - 1, nr)
    im = np.linspace(-(ni - 1), ni - 1, ni)
    rr, ii = np.meshgrid(re, im, indexing="ij")
    qam = rr + 1.j * ii
    idx1 = (abs(qam.real) > 3 * s) & (abs(qam.imag) > s)
    idx2 = (abs(qam.real) > 3 * s) & (abs(qam.imag) <= s)
    qam[idx1] = np.sign(qam[idx1].real) * (abs(qam[idx1].real) - 2 * s) + 1.j * (
        np.sign(qam[idx1].imag) * (4 * s - abs(qam[idx1].imag)))
    qam[idx2] = np.sign(qam[idx2].real) * (4 * s - abs(qam[idx2].real)) + 1.j * (
        np.sign(qam[idx2].imag) * (abs(qam[idx2].imag) + 2 * s))
    return qam.flatten()


def cal_symbols_psk(M):
    """M-PSK constellation normalised to unit power (reference theory.py:120-137)."""
    if M == 4:  # QPSK is rotated by pi/4 compared to other orders
        return np.exp(1j * (np.arange(M) * 2 * np.pi / M + np.pi / M))
    return np.exp(2j * np.arange(M) * np.pi / M)


def cal_scaling_factor_qam(M):
    """Scaling factor normalising M-QAM symbols to unit average power (reference theory.py:139-149)."""
    bits = np.log2(M)
    if not bits % 2:
        return 2 / 3 * (M - 1)
    symbols = cal_symbols_qam(M)
    return (abs(symbols) ** 2).mean()


def gray_code_qam(M):
    """Gray code map for M-QAM constellations (reference theory.py:181-193)."""
    Nbits = int(np.log2(M))
    if Nbits % 2 == 0:
        N = Nbits // 2
        idx = np.mgrid[0:2 ** N:1, 0:2 ** N:1]
    else:
        N = (Nbits - 1) // 2
        idx = np.mgrid[0:2 ** (N + 1):1, 0:2 ** N:1]
    gidx = bin2gray(idx)
    return ((gidx[0] << N) | gidx[1]).flatten()


def cal_ps_probablts(symbols, nu):
    """Maxwell-Boltzmann probabilities for probabilistic constellation shaping.

    Parity: reference theory.py:195-222.
    """
    symbs = np.unique(np.asarray(symbols).real)
    w = np.exp(-nu * np.abs(symbs) ** 2)
    return symbs, w / w.sum()


def generate_ps_symbols(N, symbs, px, normalize=True, seed=None):
    """Generate probabilistically shaped symbols (reference theory.py:224-248)."""
    rng = np.random.default_rng(seed)
    out = rng.choice(symbs, N, p=px) + 1j * rng.choice(symbs, N, p=px)
    if normalize:
        from qampy_tpu.helpers import normalise_and_center
        out = np.asarray(normalise_and_center(jnp.asarray(out)))
    return out


def hybrid_qam_ber_vs_esn0(snr, pr, fr, M1, M2):
    """BER vs SNR(dB) for time-domain hybrid QAM (reference theory.py:250-280)."""
    snr = 10 ** (np.asarray(snr) / 10)
    bps1 = np.log2(M1)
    bps2 = np.log2(M2)
    return 1 / ((1 - fr) * bps1 + fr * bps2) * (
        (1 - fr) * bps1 * ber_vs_es_over_n0_qam(snr / ((1 - fr) + fr * pr), M1)
        + fr * bps2 * ber_vs_es_over_n0_qam(pr * snr / ((1 - fr) + fr * pr), M2))


def cal_gmi(M, snr, N=10 ** 3, seed=0):
    """Monte-Carlo soft-decision GMI for a gray-coded square QAM format.

    Parity: reference theory.py:282-310 (which calls the pythran cal_gmi_mc
    kernel); here the MC sum is one vectorised jnp computation.
    """
    from qampy_tpu.core.metrics import cal_gmi_mc
    snr = np.atleast_1d(snr)
    from qampy_tpu.signals import SignalQAMGrayCoded
    s = SignalQAMGrayCoded(M, 1000, nmodes=1)
    btx = s.bitmap_mtx
    syms = s.coded_symbols
    snr_lin = 10 ** (snr / 10)
    return np.array([float(cal_gmi_mc(syms, float(sl), N, btx, seed=seed))
                     for sl in snr_lin])


def sim_mi_mc(symbols, snr, N, seed=0):
    """Monte-Carlo AWGN mutual information of a symbol alphabet (reference theory.py:312-334)."""
    from qampy_tpu.core.metrics import cal_mi_mc
    symbols = np.asarray(symbols)
    symbols = symbols / np.sqrt(np.mean(abs(symbols) ** 2))
    N0 = 10 ** (-snr / 10)
    sigma = np.sqrt(N0 / 2)
    rng = np.random.default_rng(seed)
    noise = (rng.standard_normal(N) + 1j * rng.standard_normal(N)) * sigma
    return float(cal_mi_mc(jnp.asarray(noise), jnp.asarray(symbols), N0))


def warped_qam(M, k=0.18):
    """Radially warped M-QAM: a grid-breaking geometrically shaped alphabet.

    c' = c * (1 + k*(|c|^2 - 1)), re-normalised to unit power — outer points
    pushed out, inner pulled in. ``ops.phase.detect_grid`` classifies it
    "gen": no uniform per-axis spacing survives. Used to exercise the
    general-alphabet paths of the receivers.
    """
    c = cal_symbols_qam(M) / np.sqrt(cal_scaling_factor_qam(M))
    w = c * (1 + k * (np.abs(c) ** 2 - 1))
    return (w / np.sqrt(np.mean(np.abs(w) ** 2))).astype(np.complex64)

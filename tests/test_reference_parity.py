"""Direct numeric parity tests against the actual reference implementation.

The reference's pythran modules are valid annotated Python
(/root/reference/qampy/core/equalisation/pythran_equalisation.py,
/root/reference/qampy/core/pythran_dsp.py), so the real reference kernels run
here interpreted on identical inputs and the qampy_tpu kernels must agree
element-wise (complex128 under x64 where the recurrence is exact; f32-scale
tolerances for FFT-based ops). This turns the docstring parity citations into
executed proofs.

The reference tree is imported read-only; sizes are tiny because the
interpreted reference loops are slow.
"""
import sys

import numpy as np
import pytest
import jax
import jax.numpy as jnp

if "/root/reference" not in sys.path:
    sys.path.insert(0, "/root/reference")

ref = pytest.importorskip("qampy", reason="reference tree not available")
from qampy.core.equalisation import pythran_equalisation as ref_pe  # noqa: E402
from qampy.core.equalisation import equalisation as ref_eq  # noqa: E402
from qampy.core import pythran_dsp as ref_dsp  # noqa: E402
from qampy.core import resample as ref_resample  # noqa: E402
from qampy import signals as ref_signals  # noqa: E402

from qampy_tpu.ops import equaliser as eqops  # noqa: E402
from qampy_tpu.ops import phase as phops  # noqa: E402
from qampy_tpu.core import metrics, resample  # noqa: E402
from qampy_tpu import prbs, theory  # noqa: E402


def _tx_2pol(L, M=16, os=2, seed=0, dtype=np.complex128):
    """Small dual-pol QAM waveform (host numpy, no pulse shaping needed for
    kernel-level parity)."""
    rng = np.random.default_rng(seed)
    const = (np.asarray(theory.cal_symbols_qam(M))
             / np.sqrt(float(theory.cal_scaling_factor_qam(M)))).astype(dtype)
    syms = const[rng.integers(0, M, size=(2, L))]
    E = np.zeros((2, L * os), dtype=dtype)
    E[:, ::os] = syms
    # light smearing so training has work to do, plus noise
    E = E + 0.4 * np.roll(E, 1, axis=-1) + 0.1 * np.roll(E, -2, axis=-1)
    E += 0.01 * (rng.standard_normal(E.shape) + 1j * rng.standard_normal(E.shape))
    return E.astype(dtype), syms, const


class TestTrainEqualiser:
    """qampy_tpu.ops.equaliser.train_equaliser_seq vs reference
    pythran_equalisation.train_equaliser (:130-173) on identical inputs."""

    @pytest.mark.parametrize("method", ["cma", "cma2", "mcma", "rde", "mrde",
                                        "sbd", "mddma", "dd"])
    def test_blind_methods_elementwise(self, method):
        with jax.enable_x64():
            E, _, _ = _tx_2pol(256, M=16)
            TrSyms, Niter, os, mu, ntaps = 120, 2, 2, 1e-3, 7
            wx0 = eqops._init_taps(ntaps, 2, 2, np.complex128)
            symbols = eqops._reshape_symbols(None, method, 16, np.complex128, 2)
            err_ref, wx_ref, mu_ref = ref_pe.train_equaliser(
                E.copy(), TrSyms, Niter, os, mu, wx0.copy(),
                np.arange(2), False, symbols.copy(), method)
            err, wx, mu_out = eqops.train_equaliser_seq(
                E, TrSyms, Niter, os, mu, wx0, symbols, method, adaptive=False)
            np.testing.assert_allclose(np.asarray(wx), wx_ref, rtol=1e-9, atol=1e-12)
            np.testing.assert_allclose(np.asarray(err), err_ref, rtol=1e-9, atol=1e-12)

    def test_data_aided_sbd(self):
        with jax.enable_x64():
            E, syms, _ = _tx_2pol(256, M=16)
            TrSyms, os, mu, ntaps = 120, 2, 1e-3, 7
            wx0 = eqops._init_taps(ntaps, 2, 2, np.complex128)
            symbols = syms[:, :TrSyms].copy()
            err_ref, wx_ref, _ = ref_pe.train_equaliser(
                E.copy(), TrSyms, 1, os, mu, wx0.copy(), np.arange(2), False,
                symbols.copy(), "sbd_data")
            err, wx, _ = eqops.train_equaliser_seq(
                E, TrSyms, 1, os, mu, wx0, symbols, "sbd_data", adaptive=False)
            np.testing.assert_allclose(np.asarray(wx), wx_ref, rtol=1e-9, atol=1e-12)
            np.testing.assert_allclose(np.asarray(err), err_ref, rtol=1e-9, atol=1e-12)

    def test_adaptive_stepsize_single_mode(self):
        # the reference carries one mu across its sequential mode loop, so
        # adaptive multi-mode parity is only defined per single mode
        with jax.enable_x64():
            E, _, _ = _tx_2pol(256, M=4)
            E1 = E[:1]
            TrSyms, os, mu, ntaps = 120, 2, 2e-3, 7
            wx0 = eqops._init_taps(ntaps, 1, 1, np.complex128)
            symbols = eqops._reshape_symbols(None, "cma", 4, np.complex128, 1)
            err_ref, wx_ref, mu_ref = ref_pe.train_equaliser(
                E1.copy(), TrSyms, 2, os, mu, wx0.copy(), np.arange(1), True,
                symbols.copy(), "cma")
            err, wx, mu_out = eqops.train_equaliser_seq(
                E1, TrSyms, 2, os, mu, wx0, symbols, "cma", adaptive=True)
            np.testing.assert_allclose(np.asarray(wx), wx_ref, rtol=1e-9, atol=1e-12)
            np.testing.assert_allclose(float(mu_out[0]), float(mu_ref), rtol=1e-9)


class TestApplyFilter:
    def test_elementwise(self):
        with jax.enable_x64():
            rng = np.random.default_rng(1)
            E = (rng.standard_normal((2, 512))
                 + 1j * rng.standard_normal((2, 512))).astype(np.complex128)
            wx = (rng.standard_normal((2, 2, 11))
                  + 1j * rng.standard_normal((2, 2, 11))).astype(np.complex128)
            out_ref = ref_pe.apply_filter_to_signal(E.copy(), 2, wx.copy())
            out = np.asarray(eqops.apply_filter_to_signal(E, 2, wx))
            n = min(out.shape[-1], out_ref.shape[-1])
            np.testing.assert_allclose(out[:, :n], out_ref[:, :n],
                                       rtol=1e-9, atol=1e-12)


class TestBPS:
    def test_bps_idx_elementwise(self):
        with jax.enable_x64():
            rng = np.random.default_rng(2)
            M, L, A, N = 64, 1024, 16, 8
            const = (np.asarray(theory.cal_symbols_qam(M))
                     / np.sqrt(float(theory.cal_scaling_factor_qam(M)))).astype(np.complex128)
            syms = const[rng.integers(0, M, L)]
            E = syms * np.exp(1j * 0.1 * np.sin(np.arange(L) / 50))
            E += 0.02 * (rng.standard_normal(L) + 1j * rng.standard_normal(L))
            angles = np.linspace(-np.pi / 4, np.pi / 4, A,
                                 endpoint=False).reshape(1, -1)
            # the reference's interpreted assert requires per-sample angle rows
            # (pythran strips it when compiled); identical rows keep the same
            # semantics as the broadcast (1, A) production call
            idx_ref = ref_dsp.bps(E.copy(), np.tile(angles, (L, 1)),
                                  const.copy(), N)
            idx_gen = np.asarray(phops.bps_idx(E, angles, const, N, grid=None))
            np.testing.assert_array_equal(idx_gen, idx_ref)
            # the analytic square-grid decision must agree with the O(M) search
            grid = phops.detect_square_grid(const)
            assert grid is not None
            idx_grid = np.asarray(phops.bps_idx(E, angles, const, N, grid=grid))
            np.testing.assert_array_equal(idx_grid, idx_ref)

    @pytest.mark.parametrize("M", [32, 128])
    def test_bps_idx_cross_qam_elementwise(self, M):
        """Cross-QAM analytic two-rectangle decision vs the reference's
        O(M) search (pythran_dsp.py:47-85) on identical inputs."""
        with jax.enable_x64():
            rng = np.random.default_rng(7)
            L, A, N = 512, 16, 6
            const = (np.asarray(theory.cal_symbols_qam(M))
                     / np.sqrt(float(theory.cal_scaling_factor_qam(M)))
                     ).astype(np.complex128)
            syms = const[rng.integers(0, M, L)]
            E = syms * np.exp(1j * 0.08 * np.sin(np.arange(L) / 30))
            E += 0.02 * (rng.standard_normal(L) + 1j * rng.standard_normal(L))
            angles = np.linspace(-np.pi / 4, np.pi / 4, A,
                                 endpoint=False).reshape(1, -1)
            idx_ref = ref_dsp.bps(E.copy(), np.tile(angles, (L, 1)),
                                  const.copy(), N)
            g = phops.detect_grid(const)
            assert phops.grid_decision_info(g)[0] == "x"
            idx_x = np.asarray(phops.bps_idx(E, angles, const, N, grid=g))
            np.testing.assert_array_equal(idx_x, idx_ref)

    def test_select_angles(self):
        angles = np.linspace(-1, 1, 16).reshape(1, -1)
        idx = np.array([0, 3, 15, 7], dtype=np.int32)
        np.testing.assert_allclose(np.asarray(phops.select_angles(angles, idx)),
                                   ref_dsp.select_angles(angles, idx))

    @staticmethod
    def _ref_twostage(E, A, const, N, B):
        """Faithful composition of reference bps_twostage
        (core/phaserecovery.py:222-288) from the reference's own kernels.
        The interpreted ref_dsp.bps asserts per-sample angle rows, so the
        shared stage-1 grid is tiled (identical semantics — see
        test_bps_idx_elementwise)."""
        angles = np.linspace(-np.pi / 4, np.pi / 4, A, endpoint=False,
                             dtype=E.real.dtype).reshape(1, -1)
        L = E.shape[0]
        idx = ref_dsp.bps(E.copy(), np.tile(angles, (L, 1)), const.copy(), N)
        ph = ref_dsp.select_angles(np.tile(angles, (L, 1)).copy(),
                                   idx.astype(np.int32))
        b = np.linspace(-B / 2, B / 2, B)
        phn = (ph[:, None]
               + b[None, :] / (B * A) * np.pi / 2).astype(E.real.dtype)
        idx2 = ref_dsp.bps(E.copy(), phn, const.copy(), N)
        phf = ref_dsp.select_angles(phn.copy(), idx2.astype(np.int32))
        return np.unwrap(phf * 4) / 4, phf

    def test_bps_twostage_elementwise(self):
        """XLA bps_twostage vs the reference two-stage composition
        (core/phaserecovery.py:222-288), element-wise exact (VERDICT r2 #4)."""
        with jax.enable_x64():
            rng = np.random.default_rng(2)
            M, L, A, N, B = 64, 1024, 16, 8, 4
            const = (np.asarray(theory.cal_symbols_qam(M))
                     / np.sqrt(float(theory.cal_scaling_factor_qam(M)))
                     ).astype(np.complex128)
            syms = const[rng.integers(0, M, L)]
            E = syms * np.exp(1j * 0.1 * np.sin(np.arange(L) / 50))
            E += 0.02 * (rng.standard_normal(L)
                         + 1j * rng.standard_normal(L))
            ph_ref, _ = self._ref_twostage(E, A, const, N, B)
            _, ph_x = phops.bps_twostage(E, A, const, N, B=B, method="pyt")
            np.testing.assert_allclose(np.asarray(ph_x), ph_ref,
                                       rtol=1e-9, atol=1e-12)

    def test_bps_twostage_f32_elementwise(self):
        """Two-stage BPS in float32 (default N1=N coarse window) vs the
        reference composition: agrees to f32 rounding."""
        rng = np.random.default_rng(5)
        M, L, A, N, B = 16, 2048, 16, 8, 4
        const = (np.asarray(theory.cal_symbols_qam(M))
                 / np.sqrt(float(theory.cal_scaling_factor_qam(M)))
                 ).astype(np.complex64)
        syms = const[rng.integers(0, M, L)]
        ph_true = np.cumsum(0.004 * rng.standard_normal(L))
        E = (syms * np.exp(1j * ph_true)).astype(np.complex64)
        E += (0.02 * (rng.standard_normal(L)
                      + 1j * rng.standard_normal(L))).astype(np.complex64)
        ph_ref, _ = self._ref_twostage(E.astype(np.complex128), A,
                                       const.astype(np.complex128), N, B)
        _, ph = phops.bps_twostage(jnp.asarray(E), A, jnp.asarray(const), N,
                                   B=B)
        sl = slice(2 * N, L - 2 * N)
        np.testing.assert_allclose(np.asarray(ph)[sl], ph_ref[sl], atol=1e-5)

    def test_bps_twostage_wide_coarse_deviation(self):
        """Documented deviation: the chains' two-stage BPS widens ONLY
        the coarse averaging window (N1=60 vs the reference's N) to
        suppress coarse-stage cycle slips. The fine stage keeps the reference
        window, so the output may differ from the reference composition by
        at most ~one coarse step (the fine grid re-centres around a
        different coarse pick) and both decide the TX symbols exactly on a
        benign channel."""
        rng = np.random.default_rng(5)
        M, L, A, N, B, N1 = 16, 3072, 16, 8, 4, 60
        const = (np.asarray(theory.cal_symbols_qam(M))
                 / np.sqrt(float(theory.cal_scaling_factor_qam(M)))
                 ).astype(np.complex64)
        syms = const[rng.integers(0, M, L)]
        ph_true = np.cumsum(0.004 * rng.standard_normal(L))
        E = (syms * np.exp(1j * ph_true)).astype(np.complex64)
        E += (0.01 * (rng.standard_normal(L)
                      + 1j * rng.standard_normal(L))).astype(np.complex64)
        phf_ref, _ = self._ref_twostage(E.astype(np.complex128), A,
                                        const.astype(np.complex128), N, B)
        _, phf_w = phops.bps_twostage(jnp.asarray(E), A, jnp.asarray(const),
                                      N, B=B, N1=N1)
        phf_w = np.asarray(phf_w)
        sl = slice(2 * N1, L - 2 * N1)
        coarse_step = np.pi / 2 / A
        # deviation attributable to the coarse stage only (modulo the pi/2
        # ambiguity the unwrap resolves)
        dev = (phf_w[sl] - phf_ref[sl] + np.pi / 4) % (np.pi / 2) - np.pi / 4
        assert np.all(np.abs(dev) <= 1.5 * coarse_step)
        # both variants fully recover the symbols on this channel: the
        # derotated signals decide to the same nearest points (up to the
        # pi/2 ambiguity handled identically downstream)
        for phf in (phf_ref, phf_w):
            out = E[sl] * np.exp(1j * phf[sl])
            d = np.abs(out[:, None] - const[None, :])
            dec = const[np.argmin(d, axis=-1)]
            tx = syms[sl] * np.exp(1j * (phf[sl] + ph_true[sl]))
            dtx = np.abs(tx[:, None] - const[None, :])
            dectx = const[np.argmin(dtx, axis=-1)]
            ser = np.mean(dec != dectx)
            assert ser == 0.0, ser


class TestLLRDemappers:
    def _setup(self):
        rng = np.random.default_rng(3)
        M = 64
        import qampy_tpu as qt
        sig = qt.SignalQAMGrayCoded(M, 512, nmodes=1, seed=4,
                                    dtype=np.complex128)
        bmap = np.asarray(sig.bitmap_mtx).astype(np.complex128)
        rx = (np.asarray(sig.samples)[0]
              + 0.05 * (rng.standard_normal(512) + 1j * rng.standard_normal(512)))
        return rx.astype(np.complex128), bmap, int(np.log2(M))

    def test_exact_logsumexp(self):
        with jax.enable_x64():
            rx, bmap, nbits = self._setup()
            snr = 100.0
            l_ref = ref_dsp.soft_l_value_demapper(rx.copy(), nbits, snr, bmap.copy())
            l_got = np.asarray(metrics.soft_l_value_demapper(rx, snr, bmap))
            np.testing.assert_allclose(l_got, l_ref, rtol=1e-8, atol=1e-10)

    def test_minmax(self):
        with jax.enable_x64():
            rx, bmap, nbits = self._setup()
            snr = 100.0
            l_ref = ref_dsp.soft_l_value_demapper_minmax(rx.copy(), nbits, snr,
                                                         bmap.copy())
            l_got = np.asarray(metrics.soft_l_value_demapper_minmax(rx, snr, bmap))
            np.testing.assert_allclose(l_got, l_ref, rtol=1e-8, atol=1e-10)


class TestEstimateSNR:
    def test_elementwise(self):
        with jax.enable_x64():
            rng = np.random.default_rng(5)
            M = 16
            const = (np.asarray(theory.cal_symbols_qam(M))
                     / np.sqrt(float(theory.cal_scaling_factor_qam(M)))).astype(np.complex128)
            tx = const[rng.integers(0, M, 4096)]
            rx = tx + 0.05 * (rng.standard_normal(4096) + 1j * rng.standard_normal(4096))
            snr_ref, s0_ref, n0_ref = ref_dsp.estimate_snr(rx.copy(), tx.copy(),
                                                           const.copy())
            snr, s0, n0 = metrics.estimate_snr(rx, tx, const)
            np.testing.assert_allclose(float(snr), snr_ref, rtol=1e-9)
            np.testing.assert_allclose(float(s0), s0_ref, rtol=1e-9)
            np.testing.assert_allclose(float(n0), n0_ref, rtol=1e-9)


class TestEqualiserConstants:
    @pytest.mark.parametrize("M", [4, 16, 64, 256])
    def test_partition_codebooks(self, M):
        np.testing.assert_allclose(eqops.generate_partition_codes_radius(M),
                                   ref_eq.generate_partition_codes_radius(M),
                                   rtol=1e-12)
        np.testing.assert_allclose(eqops.generate_partition_codes_complex(M),
                                   ref_eq.generate_partition_codes_complex(M),
                                   rtol=1e-12)

    @pytest.mark.parametrize("M", [4, 16, 64])
    def test_radius_constants(self, M):
        np.testing.assert_allclose(eqops._cal_Rconstant(M),
                                   ref_eq._cal_Rconstant(M), rtol=1e-12)
        np.testing.assert_allclose(eqops._cal_Rconstant_complex(M),
                                   ref_eq._cal_Rconstant_complex(M), rtol=1e-12)

    @pytest.mark.parametrize("method,M", [("cma", 16), ("mcma", 64),
                                          ("rde", 16), ("mrde", 64),
                                          ("sbd", 16), ("dd", 64)])
    def test_generate_symbols_for_eq(self, method, M):
        got = np.asarray(eqops.generate_symbols_for_eq(method, M, np.complex128)).ravel()
        want = np.asarray(ref_eq.generate_symbols_for_eq(method, M, np.complex128)).ravel()
        np.testing.assert_allclose(np.sort_complex(got), np.sort_complex(want),
                                   rtol=1e-9)


class TestPilotFrameLayout:
    @pytest.mark.parametrize("frame_len,seq_len,ins_rat",
                             [(2 ** 16, 1024, 32), (2 ** 14, 512, 32),
                              (4096, 256, 64)])
    def test_cal_pilot_idx(self, frame_len, seq_len, ins_rat):
        from qampy_tpu.signals import SignalWithPilots
        idx, idx_dat, idx_pil = SignalWithPilots._cal_pilot_idx(
            frame_len, seq_len, ins_rat)
        ridx, ridx_dat, ridx_pil = ref_signals.SignalWithPilots._cal_pilot_idx(
            frame_len, seq_len, ins_rat)
        np.testing.assert_array_equal(idx_dat, ridx_dat)
        np.testing.assert_array_equal(idx_pil, ridx_pil)


class TestResample:
    def test_rrcos_resample(self):
        with jax.enable_x64():
            rng = np.random.default_rng(6)
            sig = (rng.standard_normal(2048)
                   + 1j * rng.standard_normal(2048)).astype(np.complex128)
            out_ref = ref_resample.rrcos_resample(sig.copy(), 1.0, 2.0,
                                                  beta=0.1, taps=501)
            out = np.asarray(resample.rrcos_resample(sig, 1.0, 2.0,
                                                     beta=0.1, taps=501))
            assert out.shape == out_ref.shape
            # fftconvolve vs jnp FFT filtering: agreement to f32-scale noise
            np.testing.assert_allclose(out, out_ref, rtol=1e-6, atol=1e-7)


class TestPRBS:
    @pytest.mark.parametrize("order", [7, 15])
    def test_prbs_ext(self, order):
        taps = {7: [7, 6], 15: [15, 14]}[order]
        seed = 0b1010101 if order == 7 else 0b101010101010101
        want = ref_dsp.prbs_ext(seed, np.array(taps), order, 512)
        got = np.asarray(prbs.prbs_ext(seed, np.array(taps), order, 512))
        np.testing.assert_array_equal(got, np.asarray(want))

    def test_prbs_int(self):
        # 15-bit internal-XOR LFSR; mask convention 2^n + 2^(n-1) + 1 from
        # reference core/prbs.py make_prbs_intXOR (the top bit must be in the
        # mask so the Galois feedback clears it each shift)
        mask = 2 ** 15 + 2 ** 14 + 1
        want = ref_dsp.prbs_int(0b101010101010101, mask, 15, 512)
        got = np.asarray(prbs.prbs_int(0b101010101010101, mask, 15, 512))
        np.testing.assert_array_equal(got, np.asarray(want))


class TestMonteCarloMI:
    """qampy_tpu.core.metrics.cal_mi_mc[_fast] vs reference
    pythran_dsp.cal_mi_mc/cal_mi_mc_fast (:289-313): deterministic given the
    noise/signal realisations, so element-wise agreement is exact math."""

    def test_cal_mi_mc(self):
        with jax.enable_x64():
            rng = np.random.default_rng(11)
            const = (np.asarray(theory.cal_symbols_qam(16))
                     / np.sqrt(float(theory.cal_scaling_factor_qam(16)))
                     ).astype(np.complex128)
            N0 = 0.05
            noise = np.sqrt(N0 / 2) * (rng.standard_normal(200)
                                       + 1j * rng.standard_normal(200))
            want = ref_dsp.cal_mi_mc(noise, const, N0)
            got = float(np.asarray(metrics.cal_mi_mc(noise, const, N0)))
            np.testing.assert_allclose(got, want, rtol=1e-9)

    def test_cal_mi_mc_fast(self):
        with jax.enable_x64():
            rng = np.random.default_rng(12)
            const = (np.asarray(theory.cal_symbols_qam(16))
                     / np.sqrt(float(theory.cal_scaling_factor_qam(16)))
                     ).astype(np.complex128)
            N0 = 0.05
            tx = const[rng.integers(0, 16, 300)]
            sig = tx + np.sqrt(N0 / 2) * (rng.standard_normal(300)
                                          + 1j * rng.standard_normal(300))
            want = ref_dsp.cal_mi_mc_fast(sig, tx, const, N0)
            got = float(np.asarray(metrics.cal_mi_mc_fast(sig, tx, const, N0)))
            np.testing.assert_allclose(got, want, rtol=1e-9)


class TestLutAvg:
    """qampy_tpu.core.digital_pre_compensation.cal_lut_avg (segment sums) vs
    reference pythran_dsp.cal_lut_avg (:201-240) serial accumulation."""

    def test_elementwise(self):
        from qampy_tpu.core import digital_pre_compensation as dpc
        with jax.enable_x64():
            rng = np.random.default_rng(13)
            L, N = 500, 64
            err = (rng.standard_normal(L)
                   + 1j * rng.standard_normal(L)).astype(np.complex128)
            # reference asserts idx arrays strictly longer than err
            idx_I = rng.integers(0, N, L + 4)
            idx_Q = rng.integers(0, N, L + 4)
            want = ref_dsp.cal_lut_avg(err, idx_I, idx_Q, N)
            got = np.asarray(dpc.cal_lut_avg(err, idx_I, idx_Q, N))
            np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-12)


class TestPhaseRecoveryAux:
    """Viterbi-Viterbi, 16-QAM QPSK-partition CPE and the blind FOE vs the
    reference core/phaserecovery.py implementations (plain numpy,
    imported and run directly)."""

    def _qpsk_pn(self, L=4096, seed=21, lw_var=1e-5, snr_amp=0.02):
        rng = np.random.default_rng(seed)
        syms = np.exp(1j * (np.pi / 4 + np.pi / 2
                            * rng.integers(0, 4, L))).astype(np.complex128)
        ph = np.cumsum(rng.normal(scale=np.sqrt(lw_var), size=L))
        noisy = syms * np.exp(1j * ph) + snr_amp * (
            rng.standard_normal(L) + 1j * rng.standard_normal(L))
        return noisy

    def test_viterbiviterbi(self):
        from qampy.core import phaserecovery as ref_pr
        with jax.enable_x64():
            E = self._qpsk_pn()
            want, want_ph = ref_pr.viterbiviterbi(E, 11, 4)
            got, got_ph = phops.viterbiviterbi(E, 11, 4)
            np.testing.assert_allclose(np.asarray(got), want,
                                       rtol=1e-8, atol=1e-10)
            np.testing.assert_allclose(np.asarray(got_ph), want_ph,
                                       rtol=1e-8, atol=1e-10)

    def test_phase_partition_16qam(self):
        from qampy.core import phaserecovery as ref_pr
        with jax.enable_x64():
            rng = np.random.default_rng(22)
            const = (np.asarray(theory.cal_symbols_qam(16))
                     / np.sqrt(float(theory.cal_scaling_factor_qam(16)))
                     ).astype(np.complex128)
            sig = const[rng.integers(0, 16, 4096)]
            sig = sig * np.exp(1j * 0.1) + 0.01 * (
                rng.standard_normal(4096) + 1j * rng.standard_normal(4096))
            want, want_ph = ref_pr.phase_partition_16qam(sig, 64)
            got, got_ph = phops.phase_partition_16qam(sig, 64)
            np.testing.assert_allclose(np.asarray(got_ph), want_ph,
                                       rtol=1e-7, atol=1e-9)
            # the reference derotates the FIELD by the raw 4x-domain block
            # angle (phi_est) instead of its own returned phase estimate
            # (core/phaserecovery.py:375,380 vs :377) — its field output is
            # inconsistent with its phase output and does not recover the
            # constellation. We derotate by the returned phase (SER-verified
            # in tests/test_phaserec.py); check the field against that.
            want_field = sig * np.exp(-1j * want_ph)
            np.testing.assert_allclose(np.asarray(got), want_field,
                                       rtol=1e-7, atol=1e-9)

    def test_find_and_comp_freq_offset(self):
        from qampy.core import phaserecovery as ref_pr
        with jax.enable_x64():
            rng = np.random.default_rng(23)
            syms = np.exp(1j * (np.pi / 4 + np.pi / 2
                                * rng.integers(0, 4, (2, 8192))))
            fo = 3.3e-4
            t = np.arange(1, 8193)
            sig = syms * np.exp(2j * np.pi * fo * t)
            want = ref_pr.find_freq_offset(sig, os=1, fft_size=2 ** 14)
            got = np.asarray(phops.find_freq_offset(sig, os=1,
                                                    fft_size=2 ** 14))
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
            want_c = ref_pr.comp_freq_offset(sig, want, os=1)
            got_c = np.asarray(phops.comp_freq_offset(sig, got, os=1))
            np.testing.assert_allclose(got_c, want_c, rtol=1e-8, atol=1e-9)


class TestSyncFunctions:
    """core/sync.py vs reference core/ber_functions.py on identical inputs."""

    def _pair(self, L=4000, off=137, seed=31):
        rng = np.random.default_rng(seed)
        const = (np.asarray(theory.cal_symbols_qam(4))
                 / np.sqrt(float(theory.cal_scaling_factor_qam(4)))
                 ).astype(np.complex128)
        tx = const[rng.integers(0, 4, L)]
        rx = np.roll(tx, off) + 0.01 * (rng.standard_normal(L)
                                        + 1j * rng.standard_normal(L))
        return tx, rx

    def test_find_sequence_offset(self):
        from qampy.core import ber_functions as ref_bf
        from qampy_tpu.core import sync
        with jax.enable_x64():
            tx, rx = self._pair()
            want = ref_bf.find_sequence_offset(tx, rx)
            got = int(np.asarray(sync.find_sequence_offset(tx, rx)))
            assert got == want

    @pytest.mark.parametrize("rot", [0, 1, 2, 3])
    def test_find_sequence_offset_complex(self, rot):
        from qampy.core import ber_functions as ref_bf
        from qampy_tpu.core import sync
        with jax.enable_x64():
            tx, rx = self._pair(seed=32 + rot)
            rx = rx * 1j ** rot
            want_off, want_rx, want_ii, want_acm = \
                ref_bf.find_sequence_offset_complex(tx, rx)
            got_off, got_rx, got_ii, got_acm = \
                sync.find_sequence_offset_complex(tx, rx)
            assert int(np.asarray(got_off)) == want_off
            assert int(np.asarray(got_ii)) == want_ii
            np.testing.assert_allclose(np.asarray(got_rx), want_rx,
                                       rtol=1e-9, atol=1e-12)
            np.testing.assert_allclose(float(np.asarray(got_acm)), want_acm,
                                       rtol=1e-6)

    @pytest.mark.parametrize("case", ["same", "tx_longer", "rx_longer"])
    def test_sync_and_adjust(self, case):
        from qampy.core import ber_functions as ref_bf
        from qampy_tpu.core import sync
        with jax.enable_x64():
            tx, rx = self._pair(L=3000, off=77, seed=41)
            if case == "tx_longer":
                tx = np.concatenate([tx, tx[:500]])
            elif case == "rx_longer":
                rx = np.concatenate([rx, rx[:700]])
            for adjust in ("tx", "rx"):
                want_tx, want_rx = ref_bf.sync_and_adjust(tx, rx,
                                                          adjust=adjust)
                got_tx, got_rx = sync.sync_and_adjust(tx, rx, adjust=adjust)
                np.testing.assert_allclose(np.asarray(got_tx), want_tx,
                                           rtol=1e-9, atol=1e-12,
                                           err_msg="%s/%s tx" % (case, adjust))
                np.testing.assert_allclose(np.asarray(got_rx), want_rx,
                                           rtol=1e-9, atol=1e-12,
                                           err_msg="%s/%s rx" % (case, adjust))


class TestAnalogFrontend:
    """core/analog_frontend.py vs the reference (plain numpy)."""

    def test_comp_IQ_inbalance_and_orthonormalize(self):
        from qampy.core import analog_frontend as ref_af
        from qampy_tpu.core import analog_frontend as af
        with jax.enable_x64():
            rng = np.random.default_rng(51)
            sig = (rng.standard_normal((2, 4096))
                   + 1j * rng.standard_normal((2, 4096)))
            sig = sig + 0.1 * sig.real  # introduce IQ imbalance + DC
            # ours applies the compensation PER MODE; the reference's global
            # np.sum mixes both modes' statistics (and mutates its input) —
            # per-mode equals the reference applied to each 1-D mode
            got = np.asarray(af.comp_IQ_inbalance(sig.copy()))
            for m in range(2):
                want_m = ref_af.comp_IQ_inbalance(sig[m].copy())
                np.testing.assert_allclose(got[m], want_m,
                                           rtol=1e-9, atol=1e-12)
            want_o = ref_af.orthonormalize_signal(sig.copy(), os=1)
            got_o = np.asarray(af.orthonormalize_signal(sig.copy(), os=1))
            np.testing.assert_allclose(got_o, want_o, rtol=1e-9, atol=1e-12)


class TestMovingAverage:
    def test_moving_average(self):
        from qampy.core import filter as ref_filter
        from qampy_tpu.core import filter as filt
        with jax.enable_x64():
            rng = np.random.default_rng(61)
            x = rng.standard_normal(999)
            for N in (3, 9, 16):
                want = ref_filter.moving_average(x, N=N)
                got = np.asarray(filt.moving_average(x, N=N))
                np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-12)


class TestImpairmentsDeterministic:
    """Deterministic impairment models vs the reference (plain numpy):
    PMD Jones transfer, chromatic dispersion, DAC quantiser/clipper, MZM
    response, amplifier scaling — same field in, element-wise same out."""

    def _field(self, seed=71, shape=(2, 2048)):
        rng = np.random.default_rng(seed)
        return (rng.standard_normal(shape)
                + 1j * rng.standard_normal(shape)).astype(np.complex128)

    def test_pmd(self):
        from qampy.core import impairments as ref_imp
        from qampy_tpu.core import impairments as imp
        with jax.enable_x64():
            E = self._field()
            fs = 50e9
            want = ref_imp.apply_PMD_to_field(E.copy(), np.pi / 5.6,
                                              50e-12, fs)
            got = np.asarray(imp.apply_PMD_to_field(E, np.pi / 5.6,
                                                    50e-12, fs))
            np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-12)

    def test_dispersion(self):
        # per-mode comparison: the reference's final fftshift has no axes
        # argument (core/impairments.py:701) so on multi-mode input it also
        # shifts the MODE axis (swapping polarisations) — a reference bug we
        # do not reproduce; on 1-D input both agree exactly
        from qampy.core import impairments as ref_imp
        from qampy_tpu.core import impairments as imp
        with jax.enable_x64():
            E = self._field(72)
            got = np.asarray(imp.add_dispersion(E, 50e9, 20e-6, 100e3))
            for m in range(2):
                want_m = ref_imp.add_dispersion(E[m].copy(), 50e9,
                                                20e-6, 100e3)
                np.testing.assert_allclose(got[m], want_m,
                                           rtol=1e-9, atol=1e-11)

    def test_quantizer_and_clipper(self):
        from qampy.core import impairments as ref_imp
        from qampy.core import digital_pre_compensation as ref_dpc
        from qampy_tpu.core import impairments as imp
        from qampy_tpu.core import digital_pre_compensation as dpc
        with jax.enable_x64():
            E = self._field(73, (1, 4096))[0]
            # the reference quantiser requires a signal OBJECT (it calls
            # recreate_from_np_array unconditionally, :413) — wrap the raw
            # field in a reference signal to drive it
            host = ref_signals.SignalQAMGrayCoded(4, 4096, nmodes=1)
            want = np.asarray(ref_imp.quantize_signal_New(
                host.recreate_from_np_array(E.copy()), nbits=5))
            got = np.asarray(imp.quantize_signal_New(E, nbits=5))
            np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-12)
            want_c = ref_dpc.clipper(E.copy(), 0.8)
            got_c = np.asarray(dpc.clipper(E, 0.8))
            np.testing.assert_allclose(got_c, want_c, rtol=1e-12, atol=0)

    def test_modulator_and_amplifier(self):
        from qampy.core import impairments as ref_imp
        from qampy_tpu.core import impairments as imp
        with jax.enable_x64():
            E = 0.5 * self._field(74)
            want = ref_imp.modulator_response(E.copy(), dcbias=1, gfactr=0.9)
            got = np.asarray(imp.modulator_response(E, dcbias=1, gfactr=0.9))
            np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-12)
            want_a = ref_imp.ideal_amplifier_response(E.copy(), 2.5)
            got_a = np.asarray(imp.ideal_amplifier_response(E, 2.5))
            np.testing.assert_allclose(got_a, want_a, rtol=1e-12, atol=0)


class TestTheoryCurves:
    """Analytic SER/BER curves and PS probabilities vs the reference."""

    @pytest.mark.parametrize("M", [4, 16, 64, 32, 128])
    def test_ser_ber_vs_esn0(self, M):
        from qampy import theory as ref_theory
        with jax.enable_x64():
            snr = 10 ** (np.linspace(5, 25, 9) / 10)
            want_s = ref_theory.ser_vs_es_over_n0_qam(snr, M)
            got_s = np.asarray(theory.ser_vs_es_over_n0_qam(snr, M))
            np.testing.assert_allclose(got_s, want_s, rtol=1e-9)
            want_b = ref_theory.ber_vs_es_over_n0_qam(snr, M)
            got_b = np.asarray(theory.ber_vs_es_over_n0_qam(snr, M))
            np.testing.assert_allclose(got_b, want_b, rtol=1e-9)

    def test_ps_probabilities(self):
        from qampy import theory as ref_theory
        with jax.enable_x64():
            const = np.asarray(theory.cal_symbols_qam(64))
            want = ref_theory.cal_ps_probablts(const, 1.1)
            got = np.asarray(theory.cal_ps_probablts(const, 1.1))
            np.testing.assert_allclose(got, want, rtol=1e-9)

    def test_hybrid_qam_ber_reference_is_bitrotted(self):
        # the reference hybrid_qam_ber_vs_esn0 references an undefined name
        # 'theory' (qampy/theory.py:280) and cannot run — pin that so the
        # divergence is documented, and check ours against the composed
        # per-format formula it was meant to implement
        from qampy import theory as ref_theory
        with pytest.raises(NameError):
            ref_theory.hybrid_qam_ber_vs_esn0(np.array([12.0]), 1.2,
                                              0.4, 16, 32)
        with jax.enable_x64():
            snr_db = np.linspace(8, 22, 6)
            pr, fr, M1, M2 = 1.2, 0.4, 16, 32
            got = np.asarray(theory.hybrid_qam_ber_vs_esn0(snr_db, pr, fr,
                                                           M1, M2))
            lin = 10 ** (snr_db / 10)
            nb1, nb2 = np.log2(M1), np.log2(M2)
            b1 = np.asarray(theory.ber_vs_es_over_n0_qam(
                lin / ((1 - fr) + fr * pr), M1))
            b2 = np.asarray(theory.ber_vs_es_over_n0_qam(
                pr * lin / ((1 - fr) + fr * pr), M2))
            want = ((1 - fr) * nb1 * b1 + fr * nb2 * b2) / (
                (1 - fr) * nb1 + fr * nb2)
            np.testing.assert_allclose(got, want, rtol=1e-9)


class TestTrainEqualiserRealValued:
    """qampy_tpu real-valued trainer (train_equaliser_seq(real_valued=True))
    vs reference pythran_equalisation.train_equaliser_realvalued (:80-108)
    element-wise on identical inputs — all 4 real methods + adaptive step.

    The repo re-derives the real kernel from the SAME scan as the complex
    one (ops/equaliser.py real_valued=True); this pins that re-derivation
    against the actual reference recurrence."""

    def _real_setup(self, M=16, L=256, ntaps=7, seed=3):
        E, syms, const = _tx_2pol(L, M=M, seed=seed)
        Er = np.concatenate([E.real, E.imag], axis=0)  # _convert_sig_to_real
        wx0 = eqops._init_taps(ntaps, 4, 4, np.float64)
        return np.ascontiguousarray(Er), syms, const, wx0

    @pytest.mark.parametrize("method", ["cma", "sgncma", "dd"])
    def test_real_blind_methods_elementwise(self, method):
        with jax.enable_x64():
            Er, _, _, wx0 = self._real_setup()
            TrSyms, Niter, os, mu = 100, 2, 2, 1e-3
            symbols = eqops._reshape_symbols(
                None, method + "_real", 16, np.float64, 4)
            err_ref, wx_ref, _ = ref_pe.train_equaliser_realvalued(
                Er.copy(), TrSyms, Niter, os, mu, wx0.copy(),
                np.arange(4), False, symbols.copy(), method)
            err, wx, _ = eqops.train_equaliser_seq(
                Er, TrSyms, Niter, os, mu, wx0, symbols, method,
                adaptive=False, real_valued=True)
            np.testing.assert_allclose(np.asarray(wx), wx_ref,
                                       rtol=1e-9, atol=1e-12)
            np.testing.assert_allclose(np.asarray(err), err_ref,
                                       rtol=1e-9, atol=1e-12)

    def test_real_data_aided_elementwise(self):
        with jax.enable_x64():
            Er, syms, _, wx0 = self._real_setup()
            TrSyms, os, mu = 100, 2, 1e-3
            symbols = np.concatenate([syms.real, syms.imag],
                                     axis=0)[:, :TrSyms].copy()
            err_ref, wx_ref, _ = ref_pe.train_equaliser_realvalued(
                Er.copy(), TrSyms, 1, os, mu, wx0.copy(), np.arange(4),
                False, symbols.copy(), "dd_data")
            err, wx, _ = eqops.train_equaliser_seq(
                Er, TrSyms, 1, os, mu, wx0, symbols, "dd_data",
                adaptive=False, real_valued=True)
            np.testing.assert_allclose(np.asarray(wx), wx_ref,
                                       rtol=1e-9, atol=1e-12)
            np.testing.assert_allclose(np.asarray(err), err_ref,
                                       rtol=1e-9, atol=1e-12)

    def test_real_adaptive_stepsize_single_mode(self):
        # the reference carries ONE mu across its sequential mode loop;
        # parity for the adaptive rule is therefore pinned on a single
        # trained output mode (same caveat as the complex adaptive test)
        with jax.enable_x64():
            Er, _, _, _ = self._real_setup(M=4)
            TrSyms, os, mu, ntaps = 100, 2, 2e-3, 7
            wx0 = eqops._init_taps(ntaps, 4, 4, np.float64)
            symbols = eqops._reshape_symbols(None, "cma_real", 4,
                                             np.float64, 4)
            err_ref, wx_ref, mu_ref = ref_pe.train_equaliser_realvalued(
                Er.copy(), TrSyms, 2, os, mu, wx0.copy(), np.arange(1),
                True, symbols.copy(), "cma")
            err, wx, mu_out = eqops.train_equaliser_seq(
                Er, TrSyms, 2, os, mu, wx0[:1], symbols[:1], "cma",
                adaptive=True, real_valued=True)
            np.testing.assert_allclose(np.asarray(wx)[0], wx_ref[0],
                                       rtol=1e-9, atol=1e-12)
            np.testing.assert_allclose(np.asarray(err)[0], err_ref[0],
                                       rtol=1e-9, atol=1e-12)
            np.testing.assert_allclose(float(mu_out[0]), float(mu_ref),
                                       rtol=1e-9)


class TestExtendedMethodsOracle:
    """sca/cme trainers vs the reference formulas hand-transcribed from
    cython_errorfcts.pyx:196-241 / numba_equalisation.py:302-361 (the
    reference's own sca/cme live only in uncompilable Cython/numba).

    Pins the SCA 16x factor + R^2 convention (ErrorFctSCA(R) with
    R = sqrt(_cal_Rsca(M)); _cal_Rsca returns a squared radius) and the
    CME [R, d, beta] ordering of ops/equaliser.py:290-312."""

    @staticmethod
    def _sca_error(Xest, R):
        # numba_equalisation.ErrorFctSCA / cython ErrorFctSCA.calc_error
        # (4*x*(4R^2-4x^2) == 16*x*(R^2-x^2))
        if abs(Xest.real) >= abs(Xest.imag):
            A = 1
            B = 1 if abs(Xest.real) == abs(Xest.imag) else 0
        else:
            A = 0
            B = 1
        return (16 * Xest.real * (R ** 2 - Xest.real ** 2) * A
                + 1j * 16 * Xest.imag * (R ** 2 - Xest.imag ** 2) * B)

    @staticmethod
    def _cme_error(Xest, R, d, beta):
        # numba_equalisation.ErrorFctCME / cython ErrorFctCME.calc_error
        err = (R - abs(Xest) ** 2) * Xest
        err += beta * np.pi / (2 * d) * (np.sin(Xest.real * np.pi / d)
                                         + 1j * np.sin(Xest.imag * np.pi / d))
        return err

    def _train_ref(self, E, TrSyms, Niter, os, mu, wx, errorfct):
        # the reference trainer recurrence (pythran_equalisation.py:154-173)
        # with the transcribed error function plugged in
        nmodes = E.shape[0]
        ntaps = wx.shape[-1]
        err = np.zeros((nmodes, TrSyms * Niter), dtype=E.dtype)
        for mode in range(nmodes):
            for it in range(Niter):
                for i in range(TrSyms):
                    X = E[:, i * os: i * os + ntaps]
                    Xest = np.sum(wx[mode] * X)
                    err[mode, it * TrSyms + i] = errorfct(Xest)
                    wx[mode] = wx[mode] + mu * err[mode, it * TrSyms + i] * np.conj(X)
        return err, wx

    @pytest.mark.parametrize("method", ["sca", "cme"])
    def test_extended_elementwise(self, method):
        with jax.enable_x64():
            M = 16
            E, _, _ = _tx_2pol(256, M=M, seed=7)
            TrSyms, Niter, os, mu, ntaps = 100, 2, 2, 1e-4, 7
            wx0 = eqops._init_taps(ntaps, 2, 2, np.complex128)
            symbols = eqops._reshape_symbols(None, method, M,
                                             np.complex128, 2)
            if method == "sca":
                R = np.sqrt(eqops._cal_Rsca(M))
                fct = lambda X: self._sca_error(X, R)
                np.testing.assert_allclose(symbols[0, 0].real, R ** 2,
                                           rtol=1e-12)
            else:
                R, d, beta = symbols[0].real
                np.testing.assert_allclose(R, eqops._cal_Rconstant(M),
                                           rtol=1e-12)
                fct = lambda X: self._cme_error(X, R, d, beta)
            err_ref, wx_ref = self._train_ref(E.copy(), TrSyms, Niter, os,
                                              mu, wx0.copy(), fct)
            err, wx, _ = eqops.train_equaliser_seq(
                E, TrSyms, Niter, os, mu, wx0, symbols, method,
                adaptive=False)
            np.testing.assert_allclose(np.asarray(wx), wx_ref,
                                       rtol=1e-9, atol=1e-12)
            np.testing.assert_allclose(np.asarray(err), err_ref,
                                       rtol=1e-9, atol=1e-12)


class TestSegmentAxisEndModes:
    """utils.segment_axis end='cut'/'pad'/'wrap' vs reference
    core/segmentaxis.py:26-128 (including axis placement and axis=None)."""

    def test_end_modes_elementwise(self):
        from qampy.core import segmentaxis as ref_sa
        from qampy_tpu import utils
        with jax.enable_x64():
            rng = np.random.default_rng(7)
            x = rng.standard_normal(37)
            for length, overlap in ((4, 2), (5, 0), (8, 3)):
                for end in ("cut", "pad", "wrap"):
                    want = ref_sa.segment_axis(x, length, overlap, end=end,
                                               endvalue=-3.5)
                    got = np.asarray(utils.segment_axis(
                        x, length, overlap, axis=None, end=end,
                        endvalue=-3.5))
                    np.testing.assert_array_equal(got, want)

    def test_axis_placement(self):
        from qampy.core import segmentaxis as ref_sa
        from qampy_tpu import utils
        with jax.enable_x64():
            rng = np.random.default_rng(8)
            # exact fit ((26-6) % (6-2) == 0): the reference's stride-trick
            # path works on every axis here (its pad/wrap path raises
            # ValueError for non-trailing axes of ND arrays — stride
            # computation on the swapped copy, segmentaxis.py:104-111)
            # non-negative axes only: the reference's stride build uses
            # ``a.shape[axis + 1:]`` (segmentaxis.py:106), which for
            # axis=-1 appends the WHOLE shape and raises ValueError
            x = rng.standard_normal((26, 26, 26))
            for axis in (0, 1, 2):
                want = ref_sa.segment_axis(x, 6, 2, axis=axis, end="cut")
                got = np.asarray(utils.segment_axis(x, 6, 2, axis=axis,
                                                    end="cut"))
                np.testing.assert_array_equal(got, want)

    def test_cut_raises_when_too_short(self):
        from qampy_tpu import utils
        with pytest.raises(ValueError):
            utils.segment_axis(np.arange(3), 5, 0, end="cut")


class TestPilotCpeLegacy:
    """ops.pilots.pilot_based_cpe_legacy vs reference
    core/pilotbased_receiver.py:167-256 (the superseded block-averaged
    variant; the reference hard-codes 2 modes at :245, so parity is run at
    nmodes=2 where both agree)."""

    @pytest.mark.parametrize("upr,navg,maxblk", [(1, 3, None), (2, 5, None),
                                                 (1, 4, 40)])
    def test_elementwise(self, upr, navg, maxblk):
        from qampy.core import pilotbased_receiver as ref_pr
        from qampy_tpu.ops import pilots
        with jax.enable_x64():
            rng = np.random.default_rng(17)
            ins, nblk = 8, 64
            const = (np.asarray(theory.cal_symbols_qam(4))
                     / np.sqrt(float(theory.cal_scaling_factor_qam(4))))
            pil = const[rng.integers(0, 4, size=(2, nblk))]
            data = const[rng.integers(0, 4, size=(2, nblk * ins))]
            sym = data.copy()
            sym[:, ::ins] = pil
            ph = np.cumsum(0.02 * rng.standard_normal((2, nblk * ins)),
                           axis=-1)
            rx = sym * np.exp(1j * ph)
            rx += 0.01 * (rng.standard_normal(rx.shape)
                          + 1j * rng.standard_normal(rx.shape))
            want_d, want_ph = ref_pr.pilot_based_cpe(
                rx.copy(), pil.copy(), ins, num_average=navg,
                use_pilot_ratio=upr, max_num_blocks=maxblk)
            got_d, got_ph = pilots.pilot_based_cpe_legacy(
                rx, pil, ins, num_average=navg, use_pilot_ratio=upr,
                max_num_blocks=maxblk)
            np.testing.assert_allclose(np.asarray(got_ph), want_ph,
                                       rtol=1e-9, atol=1e-12)
            np.testing.assert_allclose(np.asarray(got_d), want_d,
                                       rtol=1e-9, atol=1e-12)

    def test_remove_phase_pilots_false(self):
        from qampy.core import pilotbased_receiver as ref_pr
        from qampy_tpu.ops import pilots
        with jax.enable_x64():
            rng = np.random.default_rng(18)
            ins, nblk = 4, 32
            rx = (rng.standard_normal((2, nblk * ins))
                  + 1j * rng.standard_normal((2, nblk * ins)))
            pil = np.exp(1j * rng.uniform(0, 2 * np.pi, (2, nblk)))
            want_d, _ = ref_pr.pilot_based_cpe(
                rx.copy(), pil.copy(), ins, num_average=3,
                remove_phase_pilots=False)
            got_d, _ = pilots.pilot_based_cpe_legacy(
                rx, pil, ins, num_average=3, remove_phase_pilots=False)
            np.testing.assert_allclose(np.asarray(got_d), want_d,
                                       rtol=1e-9, atol=1e-12)

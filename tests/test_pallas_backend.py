"""Kernel selection and the plain references behind every hand-written kernel.

The block trainer kernel (ops/trainer_triton.py) runs here in the Pallas
interpreter against the XLA block trainer; on the card the same cases run
compiled (tests marked ``gpu``). The stages whose hand-written kernels went
(the per-sample trainer, the filter, the BPS search, unwrap + derotation)
are pinned against direct numpy references at the parameters the kernels
were tested at.
"""
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from qampy_tpu.ops import _backend
from qampy_tpu.ops import equaliser as eqops
from qampy_tpu.ops import phase as phops
from qampy_tpu.ops.trainer_triton import (BLOCK_METHODS,
                                          train_equaliser_block_triton)
from qampy_tpu.theory import cal_symbols_qam, cal_scaling_factor_qam


@pytest.fixture
def field(rng):
    return (rng.standard_normal((2, 4096)) +
            1j * rng.standard_normal((2, 4096))).astype(np.complex64)


def _qam(M):
    return (cal_symbols_qam(M) / np.sqrt(cal_scaling_factor_qam(M))
            ).astype(np.complex64)


# ---------------------------------------------------------------------------
# numpy references
# ---------------------------------------------------------------------------

def _np_err(method, z, syms):
    """Reference error functions (pythran_equalisation.py:178-231)."""
    if method == "cma":
        return (syms[0].real - abs(z) ** 2) * z
    if method == "mcma":
        return ((syms[0].real - z.real ** 2) * z.real
                + 1j * (syms[0].imag - z.imag ** 2) * z.imag)
    if method == "rde":
        n = (syms.shape[0] + 1) // 2
        codes, parts = syms[:n].real, syms[n:].real
        sq = abs(z) ** 2
        return z * (codes[np.sum(sq > parts)] - sq)
    raise ValueError(method)


def _np_train_seq(E, TrSyms, Niter, os, mu, wx, syms, method, adaptive):
    """Per-sample LMS recurrence of the reference (pythran_equalisation.py
    :130-173) as a plain loop, float64."""
    E = E.astype(np.complex128)
    wout, mus = [], []
    for m in range(wx.shape[0]):
        w = wx[m].astype(np.complex128).copy()
        mu_c, ep = mu, 0j
        for i in range(Niter * TrSyms):
            tr = i % TrSyms
            X = E[:, tr * os: tr * os + w.shape[-1]]
            err = _np_err(method, np.sum(w * X), syms[m])
            w = w + mu_c * err * np.conj(X)
            if adaptive and tr > 0 and not (err.real * ep.real > 0
                                            and err.imag * ep.imag > 0):
                mu_c = mu_c / (1 + mu_c * abs(ep) ** 2)
            ep = err
        wout.append(w)
        mus.append(mu_c)
    return np.stack(wout), np.array(mus)


def _np_fir(E, wx, os):
    """out[j, i] = sum_{k,t} E[k, i*os+t] * wx[j, k, t]."""
    ntaps = wx.shape[-1]
    Lout = (E.shape[-1] - ntaps) // os + 1
    out = np.zeros((wx.shape[0], Lout), np.complex128)
    for i in range(Lout):
        out[:, i] = np.sum(E[None, :, i * os: i * os + ntaps] * wx, axis=(1, 2))
    return out


def _np_bps_idx(E, angles, const, N):
    """Blind phase search index (reference pythran_dsp.py:26-85): 2N
    running-window sum of the nearest-point distance, argmin over the test
    angles; positions outside [N, L-N) are 0."""
    rot = E[:, None].astype(np.complex128) * np.exp(1j * angles)[None, :]
    d = np.min(np.abs(rot[:, :, None] - const[None, None, :]) ** 2, axis=-1)
    c = np.concatenate([np.zeros((1, d.shape[1])), np.cumsum(d, axis=0)])
    L, N2 = E.shape[0], 2 * N
    idx = np.zeros(L, np.int64)
    for i in range(N2, L):
        idx[i - N] = np.argmin(c[i + 1] - c[i + 1 - N2])
    return idx


def _bps_signal(rng, M=64, L=3000, lw=0.1):
    const = _qam(M)
    ph = np.cumsum(rng.normal(0, lw / np.sqrt(L), (2, L)), axis=-1)
    E = (const[rng.integers(0, M, (2, L))] * np.exp(1j * ph)
         + .01 * (rng.standard_normal((2, L)) + 1j * rng.standard_normal((2, L)))
         ).astype(np.complex64)
    return const, E


def _assert_idx_close(got, want):
    # identical except rare near-tie argmin flips between adjacent angles
    # (float32 window sums vs the float64 reference)
    mism = got != want
    assert mism.mean() < 2e-3
    if mism.any():
        assert np.abs(got.astype(int) - want.astype(int))[mism].max() <= 1


class TestPallasParity:
    """The exact per-sample trainer (the ``seq`` scan) vs a plain loop."""

    @pytest.mark.parametrize("method", ["cma", "mcma", "rde"])
    @pytest.mark.parametrize("adaptive", [False, True])
    def test_matches_seq_backend(self, field, method, adaptive):
        w0 = eqops._init_taps(11, 2, 2, np.complex64)
        syms = eqops._reshape_symbols(None, method, 16, np.complex64, 2)
        _, w_s, mu_s = eqops.train_equaliser_seq(field, 1000, 1, 2, 1e-3, w0,
                                                 syms, method,
                                                 adaptive=adaptive)
        w_n, mu_n = _np_train_seq(field, 1000, 1, 2, 1e-3, w0, syms, method,
                                  adaptive)
        assert np.allclose(np.asarray(w_s), w_n, atol=1e-4)
        assert np.allclose(np.asarray(mu_s), mu_n, atol=1e-6)

    def test_niter(self, field):
        w0 = eqops._init_taps(11, 2, 2, np.complex64)
        syms = eqops._reshape_symbols(None, "cma", 4, np.complex64, 2)
        _, w_s, _ = eqops.train_equaliser_seq(field, 500, 3, 2, 1e-3, w0,
                                              syms, "cma")
        w_n, _ = _np_train_seq(field, 500, 3, 2, 1e-3, w0, syms, "cma", False)
        assert np.allclose(np.asarray(w_s), w_n, atol=1e-4)

    def test_unknown_method_raises(self, field):
        """The removed per-sample kernel backends are refused by name."""
        for backend in ("pallas", "pallas_block"):
            with pytest.raises(ValueError, match="unknown equaliser backend"):
                eqops.equalise_signal(field, 2, 1e-3, 16, Ntaps=11,
                                      TrSyms=256, method="cma",
                                      backend=backend)


class TestPallasBPS:
    """XLA blind phase search vs the direct numpy search."""

    @pytest.mark.parametrize("L,A,N", [(512, 64, 14), (256, 32, 8),
                                       (1024, 64, 10)])
    def test_matches_xla_idx(self, rng, L, A, N):
        const, E = _bps_signal(rng, L=L)
        angles = np.linspace(-np.pi / 4, np.pi / 4, A, endpoint=False,
                             dtype=np.float32)
        grid = phops.detect_grid(const)
        got = np.asarray(jax.vmap(lambda e: phops.bps_idx(
            e, angles.reshape(1, -1), jnp.asarray(const), N,
            grid=grid))(jnp.asarray(E)))
        for m in range(2):
            _assert_idx_close(got[m], _np_bps_idx(E[m], angles, const, N))

    @pytest.mark.parametrize("M", [32, 128, 8])
    def test_matches_xla_idx_nonsquare(self, rng, M):
        """Cross (32/128) and rectangular (8) QAM ride the analytic
        decision; it must agree with the direct O(M) search."""
        const, E = _bps_signal(rng, M=M, L=1024)
        grid = phops.detect_grid(const)
        assert phops.grid_decision_info(grid)[0] in ("x", "r")
        angles = np.linspace(-np.pi / 4, np.pi / 4, 32, endpoint=False,
                             dtype=np.float32)
        got = np.asarray(phops.bps_idx(jnp.asarray(E[0]),
                                       angles.reshape(1, -1),
                                       jnp.asarray(const), 8, grid=grid))
        _assert_idx_close(got, _np_bps_idx(E[0], angles, const, 8))

    def test_matches_xla_idx_general_alphabet(self, rng):
        """The ("gen", ...) path — arbitrary alphabets — evaluates the
        expanded-square search; must equal the direct search."""
        const, E = _bps_signal(rng, M=32, L=1024)
        angles = np.linspace(-np.pi / 4, np.pi / 4, 32, endpoint=False,
                             dtype=np.float32)
        got = np.asarray(phops.bps_idx(jnp.asarray(E[0]),
                                       angles.reshape(1, -1),
                                       jnp.asarray(const), 8, grid=None))
        _assert_idx_close(got, _np_bps_idx(E[0], angles, const, 8))

    @pytest.mark.parametrize("tile_rows", [1, 7, 64, 4096])
    def test_gen_tiled_matches_untiled(self, rng, tile_rows):
        """The general-alphabet distance in time tiles (lax.map, ragged
        last tile) equals the one-shot evaluation to float32 rounding (a
        tile's matmul may take another summation order)."""
        const, E = _bps_signal(rng, M=16, L=300)
        ang = np.linspace(-np.pi / 4, np.pi / 4, 8, endpoint=False)
        EE = jnp.asarray((E[0][:, None] * np.exp(1j * ang)[None, :])
                         .astype(np.complex64))
        s = jnp.asarray(const)
        whole = np.asarray(phops._gen_min_dist_sq(EE, s, tile_rows=10 ** 6))
        tiled = np.asarray(phops._gen_min_dist_sq(EE, s, tile_rows=tile_rows))
        assert tiled.shape == whole.shape == (300, 8)
        np.testing.assert_allclose(tiled, whole, rtol=1e-6, atol=1e-6)

    @pytest.mark.parametrize("A,B,N", [(16, 8, 14), (32, 4, 8)])
    def test_twostage_matches_xla(self, rng, A, B, N):
        """Two-stage BPS with the decision grid passed explicitly (the
        chain's fitted-grid hook) equals the detected-grid default."""
        const, E = _bps_signal(rng)
        grid = phops.detect_grid(const)
        _, ph_ref = phops.bps_twostage(E, A, const, N, B=B)
        _, ph_got = phops.bps_twostage(E, A, const, N, B=B, grid=grid,
                                       grid_coarse=grid)
        np.testing.assert_array_equal(np.asarray(ph_got), np.asarray(ph_ref))

    def test_twostage_dispatch(self, rng):
        """``method=`` is accepted for API compatibility and ignored."""
        const, E = _bps_signal(rng, L=2048)
        out_p, ph_p = phops.bps_twostage(E, 16, const, 8, B=8, method="pallas")
        out_x, ph_x = phops.bps_twostage(E, 16, const, 8, B=8, method="pyt")
        np.testing.assert_array_equal(np.asarray(ph_p), np.asarray(ph_x))

    def test_bps_method_dispatch(self, rng):
        """bps(method=...) is one XLA path whatever the method name."""
        const, E = _bps_signal(rng, L=2048)
        out_p, ph_p = phops.bps(E, 32, const, 8, method="pallas")
        out_x, ph_x = phops.bps(E, 32, const, 8, method="pyt")
        np.testing.assert_array_equal(np.asarray(ph_p), np.asarray(ph_x))


def _trainer_case(field, method, M=16, adaptive=True, TrSyms=1024, Niter=2,
                  block_size=128, ntaps=11, nout=2, syms=None):
    w0 = eqops._init_taps(ntaps, 2, 2, np.complex64)[:nout]
    if syms is None:
        syms = eqops._reshape_symbols(None, method, M, np.complex64, 2)
    syms = np.asarray(syms)[:nout]
    args = (field, TrSyms, Niter, 2, 1e-3, w0, syms, method)
    kw = dict(adaptive=adaptive, block_size=block_size)
    ref = eqops.train_equaliser_block(*args, **kw)
    got = train_equaliser_block_triton(*args, interpret=True, **kw)
    return ref, got


def _assert_trainer_close(ref, got):
    (err_b, w_b, mu_b), (err_p, w_p, mu_p) = ref, got
    assert w_p.shape == w_b.shape and err_p.shape == err_b.shape
    assert np.allclose(np.asarray(w_b), np.asarray(w_p), atol=1e-4)
    assert np.allclose(np.asarray(mu_b), np.asarray(mu_p), atol=1e-6)
    assert np.allclose(np.asarray(err_b), np.asarray(err_p), atol=1e-3)


class TestPallasBlockTrainer:
    """Block-LMS trainer kernel (interpret mode) vs the XLA block trainer."""

    @pytest.mark.parametrize("method", ["cma", "mcma", "rde", "sbd", "mddma", "dd"])
    @pytest.mark.parametrize("adaptive", [False, True])
    def test_matches_block_backend(self, field, method, adaptive):
        _assert_trainer_close(*_trainer_case(field, method,
                                             adaptive=adaptive))

    @pytest.mark.parametrize("method", ["sbd", "mddma", "dd"])
    def test_matches_block_backend_cross_qam(self, field, method):
        """Decision methods on cross 32-QAM: the joint two-rectangle
        decision must reproduce the XLA block trainer's O(M) search."""
        _assert_trainer_close(*_trainer_case(field, method, M=32))

    @pytest.mark.parametrize("method", ["sbd", "mddma", "dd"])
    def test_matches_block_backend_gen_alphabet(self, field, method):
        """Decision methods on a general (warped, non-grid) alphabet: the
        statically unrolled O(M) max-score search must reproduce the XLA
        block trainer's matmul decision."""
        from qampy_tpu.theory import warped_qam
        const = warped_qam(64)
        assert phops.grid_decision_info(phops.detect_grid(const))[0] == "gen"
        _assert_trainer_close(*_trainer_case(
            field, method, syms=np.tile(const[None, :], (2, 1))))

    def test_via_equalise_signal_backend(self, monkeypatch):
        """On a GPU platform the blind chain trains with the kernel: with
        the platform spoofed and the kernel interpreted, the chain reports
        the triton family and reproduces the XLA chain's symbols."""
        import qampy_tpu.ops.trainer_triton as tt
        from functools import partial
        from qampy_tpu.ops.chain import make_rx_chain
        from bench import make_tx
        E, _, _ = make_tx(2 ** 13, M=16, snr=30)
        kw = dict(M=16, Ntaps=11, bps_angles=16, bps_N=8, block_size=64,
                  TrSyms=4096)
        out_x = np.asarray(jax.jit(make_rx_chain(pallas=False, **kw))(E))
        monkeypatch.setattr(_backend, "platform", lambda: "gpu")
        monkeypatch.setattr(tt, "train_equaliser_block_triton",
                            partial(tt.train_equaliser_block_triton,
                                    interpret=True))
        fwd = make_rx_chain(**kw)
        assert fwd.backend_info["family"] == "triton"
        out_k = np.asarray(jax.jit(fwd)(E))
        assert np.allclose(out_k, out_x, atol=1e-3)


class TestTritonWrapperShapes:
    """Padding and shape handling of the kernel wrapper."""

    @pytest.mark.parametrize("ntaps,block_size,TrSyms,Niter,nout", [
        (9, 64, 1024, 1, 2),      # K=18 taps padded to 32 rows
        (17, 512, 1024, 3, 2),    # K=34 -> 64 rows, chunked block, wraps
        (11, 256, 128, 2, 2),     # TrSyms < block_size: one block
        (11, 64, 1000, 1, 1),     # one output mode; ragged prefix dropped
    ])
    def test_padding_and_geometry(self, field, ntaps, block_size, TrSyms,
                                  Niter, nout):
        _assert_trainer_close(*_trainer_case(
            field, "mcma", ntaps=ntaps, block_size=block_size,
            TrSyms=TrSyms, Niter=Niter, nout=nout))

    @pytest.mark.parametrize("block_size", [96, 8])
    def test_non_power_of_two_block_raises(self, field, block_size):
        with pytest.raises(ValueError, match="power of two"):
            _trainer_case(field, "cma", block_size=block_size)

    def test_rejects_unimplemented(self, field):
        with pytest.raises(ValueError, match="implements"):
            _trainer_case(field, "cma2")
        w0 = eqops._init_taps(11, 2, 2, np.complex64)
        with pytest.raises(ValueError, match="complex methods"):
            train_equaliser_block_triton(field, 256, 1, 2, 1e-3, w0,
                                         np.ones((2, 1)), "cma",
                                         real_valued=True, interpret=True)


class TestResolver:
    """One platform resolver (ops/_backend.py)."""

    def test_gpu_platform_takes_triton_family(self):
        assert _backend.family("gpu") == "triton"
        assert _backend.use_kernel(None, platform_name="gpu") is True
        # an ineligible configuration falls back to XLA only when implicit
        assert _backend.use_kernel(None, ("x",), platform_name="gpu") is False

    @pytest.mark.parametrize("platform", ["cpu", "rocm", "METAL"])
    def test_other_platforms_take_xla(self, platform):
        assert _backend.family(platform) == "xla"
        assert _backend.use_kernel(None, platform_name=platform) is False
        assert _backend.use_kernel(False, platform_name=platform) is False

    def test_impossible_pallas_request_raises(self):
        with pytest.raises(ValueError, match="no hand-written kernel"):
            _backend.use_kernel(True, platform_name="cpu")
        with pytest.raises(ValueError, match="cannot take it"):
            _backend.use_kernel(True, ("block of 96",), platform_name="gpu")
        # on this (CPU) test platform the chains refuse pallas=True
        from qampy_tpu.ops.chain import make_rx_chain
        with pytest.raises(ValueError, match="no hand-written kernel"):
            make_rx_chain(pallas=True)

    def test_pallas_routes_in_package(self):
        """Every Pallas submodule the package imports is a GPU route."""
        import ast
        root = os.path.dirname(os.path.dirname(os.path.abspath(
            eqops.__file__)))
        hits = []
        for d, _, files in os.walk(root):
            for f in files:
                if not f.endswith(".py"):
                    continue
                tree = ast.parse(open(os.path.join(d, f)).read())
                for node in ast.walk(tree):
                    if isinstance(node, ast.ImportFrom) and node.module:
                        names = [node.module + "." + a.name
                                 for a in node.names]
                    elif isinstance(node, ast.Import):
                        names = [a.name for a in node.names]
                    else:
                        continue
                    hits += [(f, n) for n in names
                             if n.startswith("jax.experimental.pallas.")
                             and n.split(".")[3] not in ("triton",
                                                         "mosaic_gpu")]
        assert not hits, hits

    def test_interpret_only_when_asked(self, field):
        """The kernel never picks the interpreter itself: its default is
        compiled, which the CPU cannot run."""
        import inspect
        sig = inspect.signature(train_equaliser_block_triton)
        assert sig.parameters["interpret"].default is False
        w0 = eqops._init_taps(11, 2, 2, np.complex64)
        syms = eqops._reshape_symbols(None, "cma", 16, np.complex64, 2)
        with pytest.raises(Exception):
            jax.block_until_ready(train_equaliser_block_triton(
                field, 256, 1, 2, 1e-3, w0, syms, "cma", block_size=64))


class TestCompiledTrainer:
    """The kernel compiled for the card vs XLA (run by chip_smoke.py)."""

    @pytest.mark.gpu
    @pytest.mark.parametrize("method", BLOCK_METHODS)
    def test_compiled_matches_xla(self, gpu, field, method):
        w0 = eqops._init_taps(17, 2, 2, np.complex64)
        syms = eqops._reshape_symbols(None, method, 64, np.complex64, 2)
        args = (field, 1024, 2, 2, 1e-3, w0, syms, method)
        kw = dict(adaptive=True, block_size=256)
        ref = eqops.train_equaliser_block(*args, **kw)
        got = train_equaliser_block_triton(*args, **kw)
        _assert_trainer_close(ref, got)


class TestFilterFormulation:
    """apply_filter_to_signal (windows-batched matmul) vs direct windows."""

    @pytest.mark.parametrize("os", [1, 2])
    @pytest.mark.parametrize("ntaps", [11, 17])
    def test_matches_direct(self, rng, os, ntaps):
        E = (rng.standard_normal((2, 3000)) +
             1j * rng.standard_normal((2, 3000))).astype(np.complex64)
        wx = (rng.standard_normal((2, 2, ntaps)) +
              1j * rng.standard_normal((2, 2, ntaps))).astype(np.complex64) * 0.1
        got = np.asarray(eqops.apply_filter_to_signal(E, os, wx))
        want = _np_fir(E, wx, os)
        assert got.shape == want.shape
        assert np.allclose(got, want, atol=2e-4)

    def test_real_valued(self, rng):
        E = rng.standard_normal((4, 2000)).astype(np.float32)
        wx = rng.standard_normal((4, 4, 9)).astype(np.float32) * 0.1
        got = np.asarray(eqops.apply_filter_to_signal(E, 2, wx))
        want = _np_fir(E, wx, 2).real
        assert np.allclose(got, want, atol=2e-4)


class TestPallasUnwrapDerotate:
    """XLA pi/2 unwrap + derotation vs numpy's unwrap."""

    @pytest.mark.parametrize("L", [5000, 1024, 333])
    def test_matches_xla(self, rng, L):
        E = (rng.standard_normal((2, L)) +
             1j * rng.standard_normal((2, L))).astype(np.complex64)
        # slow drift with genuine pi/2 wraps
        drift = (np.cumsum(rng.standard_normal((2, L)) * 0.02, axis=-1)
                 + np.linspace(0, 9, L))
        ph = ((drift + np.pi / 4) % (np.pi / 2) - np.pi / 4).astype(np.float32)
        got = np.asarray(phops.derotate(jnp.asarray(E), phops.unwrap_quarter(
            jnp.asarray(ph))))
        want = E * np.exp(1j * np.unwrap(ph.astype(np.float64) * 4) / 4)
        assert got.dtype == E.dtype
        assert np.allclose(got, want, atol=1e-4)

    @pytest.mark.parametrize("at", [1024, 128, 640])
    def test_unwrap_carries_across_boundaries(self, at):
        """A pi/2 wrap anywhere in the trace carries to every later sample."""
        L = 4096
        E = np.ones((1, L), np.complex64)
        ph = np.full((1, L), np.pi / 4 - 0.01, np.float32)
        ph[0, at:] = -np.pi / 4 + 0.01  # wraps by ~pi/2 at `at`
        got = np.asarray(phops.derotate(jnp.asarray(E), phops.unwrap_quarter(
            jnp.asarray(ph))))
        # unwrapped phase after the wrap is pi/4 - 0.01 + 0.02 (continuous),
        # NOT -pi/4 + 0.01
        assert np.allclose(np.angle(got[0, at:]), np.pi / 4 + 0.01, atol=1e-4)
        assert np.allclose(np.angle(got[0, :at]), np.pi / 4 - 0.01, atol=1e-4)


class TestPallasApplyFilter:
    """The filter at the former fused kernel's test shapes vs a direct FIR,
    and the decimated read of the filter output (decimated carrier
    recovery) vs the direct FIR at the decimated stride."""

    @pytest.mark.parametrize("L,ntaps,os,nmodes,dec", [
        (5000, 17, 2, 2, 8),
        (4096, 11, 2, 2, 16),
        (3000, 17, 2, 1, 4),     # single pol
        (6000, 17, 4, 2, 8),     # os=4
    ])
    def test_matches_xla(self, rng, L, ntaps, os, nmodes, dec):
        E = (rng.standard_normal((nmodes, L)) +
             1j * rng.standard_normal((nmodes, L))).astype(np.complex64)
        wxy = ((rng.standard_normal((nmodes, nmodes, ntaps)) +
                1j * rng.standard_normal((nmodes, nmodes, ntaps))) * 0.1
               ).astype(np.complex64)
        got = np.asarray(eqops.apply_filter_to_signal(E, os, wxy))
        want = _np_fir(E, wxy, os)
        assert got.shape == want.shape
        assert np.allclose(got, want, atol=1e-4)
        # decimated read: every dec-th symbol is the FIR at stride os*dec
        assert np.allclose(got[:, ::dec], want[:, ::dec], atol=1e-4)
        Ed = _np_fir(E, wxy, os * dec)
        assert np.allclose(got[:, ::dec][:, :Ed.shape[-1]], Ed, atol=1e-4)

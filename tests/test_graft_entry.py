"""Driver-contract tests for __graft_entry__.

The round driver compile-checks ``entry()`` single-chip and runs
``dryrun_multichip(n)`` on a virtual CPU mesh; these tests pin that
contract so refactors cannot silently break it.
"""
import sys

import numpy as np
import jax
import pytest

sys.path.insert(0, ".")
import __graft_entry__ as graft


class TestEntry:
    def test_entry_is_host_only(self):
        # building the example args must not touch the device: everything
        # numpy, real planes
        fn, args = graft.entry()
        assert all(isinstance(a, np.ndarray) for a in args)
        assert all(a.dtype == np.float32 or a.dtype == np.float64
                   for a in args)

    def test_entry_jits_and_converges(self):
        fn, args = graft.entry()
        out = np.asarray(jax.jit(fn)(*args))
        assert out.ndim == 2 and np.isfinite(out).all()
        from qampy_tpu.theory import cal_symbols_qam, cal_scaling_factor_qam
        const = np.asarray(cal_symbols_qam(64)) / np.sqrt(
            float(cal_scaling_factor_qam(64)))
        d = np.abs(out[:, 500:-500, None] - const[None, None, :]).min(-1)
        assert d.mean() < 0.1

    def test_flagship_block_size_kernel_valid(self):
        # the block trainer kernel takes power-of-two blocks; the flagship
        # defaults must satisfy it so the GPU runs the kernel
        import inspect
        from qampy_tpu.ops.trainer_triton import check_shapes
        defaults = inspect.signature(graft._flagship_fn).parameters
        assert check_shapes(2 ** 14, defaults["block_size"].default) == ()


class TestDryrun:
    def test_dryrun_multichip(self):
        # conftest already forces an 8-device CPU backend
        graft.dryrun_multichip(8)


class TestBenchGateMath:
    def test_hamming_lut_ber_matches_bitmap(self):
        """bench.py counts bit errors through a (M, M) Hamming-distance
        LUT gather instead of gathering (nmodes, Nsym, log2M) bitmaps.
        The LUT form must equal the bitmap form exactly."""
        import numpy as np
        rng = np.random.default_rng(0)
        M, nb, N = 64, 6, 50000
        bits = rng.integers(0, 2, size=(M, nb)).astype(np.float32)
        idx_rx = rng.integers(0, M, size=(2, N))
        idx_tx = rng.integers(0, M, size=(2, N))
        ber_bitmap = np.mean(bits[idx_rx] != bits[idx_tx])
        ham = (bits[:, None, :] != bits[None, :, :]).sum(-1).astype(
            np.float32).reshape(-1)
        ber_lut = np.mean(ham[idx_rx * M + idx_tx]) / nb
        assert np.isclose(ber_bitmap, ber_lut, rtol=0, atol=1e-6)  # f32 mean

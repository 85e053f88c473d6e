"""Block-LMS equaliser trainer as one Pallas kernel on the Triton route.

Same math as :func:`qampy_tpu.ops.equaliser.train_equaliser_block`: the
training prefix is split into blocks of ``S`` symbols, the taps are frozen
within a block, and the block's summed update and the aggregated
adaptive-stepsize rule are applied at its end. The recurrence over blocks is
strictly serial, so XLA runs it as a device loop of several small kernels
per block step. Here the whole loop runs inside one program per output
mode: the taps, the step size and the last error stay in registers, and
each block step reads its training windows from the pre-gathered window
matrix (``lax.fori_loop`` over ``pl.ds`` loads) and writes its error trace,
from which the adaptive step-size rule reads each symbol's predecessor.

Complex arithmetic runs on split real/imaginary planes. The tap axis is
padded with zero rows to a power of two, as Triton wants; zero rows get a
zero update and stay zero. The decision-directed methods use the analytic
nearest-point decision of a square/cross/rectangular grid, or a statically
unrolled search over a general alphabet of up to 256 points.
"""
from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from qampy_tpu.ops.equaliser import training_windows

#: modulus-type methods the kernel implements (reference
#: pythran_equalisation.py:178-231; sgncma maps to cma there too)
_MODULUS_METHODS = ("cma", "sgncma", "mcma", "rde")
#: decision-directed methods, on an analytic grid or an unrolled alphabet
_DECISION_METHODS = ("sbd", "mddma", "dd")
#: methods implemented by the kernel
BLOCK_METHODS = _MODULUS_METHODS + _DECISION_METHODS
#: largest general (non-grid) alphabet the unrolled decision takes
MAX_GEN_POINTS = 256
#: columns of a block processed per inner chunk (bounds register use),
#: and the Triton launch parameters: the fastest of seven variants timed
#: on an H100 at the bench shapes (tools/trainer_ab.py, PERF.md)
_CHUNK, _NUM_WARPS, _NUM_STAGES = 256, 8, 2


def _next_pow2(n):
    return 1 << max(0, int(n) - 1).bit_length()


def _decision_fn(grid):
    """Nearest-point decision ``(zr, zi) -> (dr, di)`` for a grid spec of
    :func:`qampy_tpu.ops.phase.detect_grid`."""
    from qampy_tpu.ops.phase import grid_decision_info
    kind, p = grid_decision_info(grid)
    if kind == "sq":
        d0, lo, n = p
        nm1 = float(n - 1)

        def dec(zr, zi):
            dr = lo + d0 * jnp.clip(jnp.floor((zr - lo) / d0 + 0.5), 0.0, nm1)
            di = lo + d0 * jnp.clip(jnp.floor((zi - lo) / d0 + 0.5), 0.0, nm1)
            return dr, di
    elif kind == "r":
        d0, lor, nr, loi, ni = p

        def dec(zr, zi):
            dr = lor + d0 * jnp.clip(jnp.floor((zr - lor) / d0 + 0.5), 0.0,
                                     float(nr - 1))
            di = loi + d0 * jnp.clip(jnp.floor((zi - loi) / d0 + 0.5), 0.0,
                                     float(ni - 1))
            return dr, di
    elif kind == "x":
        # the cross is a union of two axis-aligned rectangles: the nearest
        # point is the closer of the two per-rectangle clamps (exact)
        d0, lo, n, c = p
        nm1, cc, ccm = float(n - 1), float(c), float(n - 1 - c)

        def dec(zr, zi):
            x = (zr - lo) / d0
            y = (zi - lo) / d0
            rx = jnp.floor(x + 0.5)
            ry = jnp.floor(y + 0.5)
            iA, jA = jnp.clip(rx, 0.0, nm1), jnp.clip(ry, cc, ccm)
            iB, jB = jnp.clip(rx, cc, ccm), jnp.clip(ry, 0.0, nm1)
            useA = ((x - iA) ** 2 + (y - jA) ** 2
                    <= (x - iB) ** 2 + (y - jB) ** 2)
            return (lo + d0 * jnp.where(useA, iA, iB),
                    lo + d0 * jnp.where(useA, jA, jB))
    elif kind == "gen":
        # max of the score 2<z,s> - |s|^2 = |z|^2 - |z-s|^2 over the points
        # (compile-time constants), the same argmin as the XLA decision
        pts = [(float(a), float(b), float(a * a + b * b))
               for a, b in zip(*p)]

        def dec(zr, zi):
            a0, b0, c0 = pts[0]
            best = 2.0 * (zr * a0 + zi * b0) - c0
            dr = jnp.full_like(zr, a0)
            di = jnp.full_like(zi, b0)
            for a, b, c in pts[1:]:
                sc = 2.0 * (zr * a + zi * b) - c
                take = sc > best
                dr = jnp.where(take, a, dr)
                di = jnp.where(take, b, di)
                best = jnp.maximum(sc, best)
            return dr, di
    else:
        raise ValueError("no analytic decision for grid kind %r" % kind)
    return dec


def _error_fn(method, grid, cr, ci, ncode):
    """Error ``(zr, zi) -> (er, ei)`` of one output mode; ``cr``/``ci``
    are the scalar constants of that mode's symbol row."""
    if method in ("cma", "sgncma"):
        def fn(zr, zi):
            d = cr[0] - (zr * zr + zi * zi)
            return d * zr, d * zi
    elif method == "mcma":
        def fn(zr, zi):
            return (cr[0] - zr * zr) * zr, (ci[0] - zi * zi) * zi
    elif method == "rde":
        # codebook walk over the partition boundaries (reference layout
        # [codes..., partitions...]): r = code[k] for the k-th shell
        def fn(zr, zi):
            sq = zr * zr + zi * zi
            r = jnp.zeros_like(sq) + cr[0]
            for k in range(ncode - 1):
                r = r + jnp.where(sq > cr[ncode + k], cr[k + 1] - cr[k], 0.0)
            d = r - sq
            return d * zr, d * zi
    else:
        dec = _decision_fn(grid)
        if method == "sbd":
            def fn(zr, zi):
                dr, di = dec(zr, zi)
                return (dr - zr) * jnp.abs(dr), (di - zi) * jnp.abs(di)
        elif method == "mddma":
            def fn(zr, zi):
                dr, di = dec(zr, zi)
                return (dr * dr - zr * zr) * zr, (di * di - zi * zi) * zi
        else:  # dd
            def fn(zr, zi):
                dr, di = dec(zr, zi)
                return dr - zr, di - zi
    return fn


def check_shapes(TrSyms, block_size):
    """Reasons the kernel cannot take this training geometry (empty if it
    can): the block is one power-of-two Triton tile."""
    S = min(int(block_size), int(TrSyms))
    if S & (S - 1) or S < 16:
        return ("block of %d symbols is not a power of two >= 16" % S,)
    return ()


def train_equaliser_block_triton(E, TrSyms, Niter, os, mu, wx, symbols,
                                 method, adaptive=False, real_valued=False,
                                 block_size=256, interpret=False):
    """Block-LMS training as one Pallas kernel (Triton route).

    Same contract and math as ops/equaliser.train_equaliser_block; returns
    ``(err, wx_out, mu_out)``. Complex methods cma/sgncma/mcma/rde and the
    decision-directed sbd/mddma/dd; the decision grid is detected
    host-side, so pass ``symbols`` as a concrete host array for those.
    ``interpret=True`` runs the kernel in the Pallas interpreter (tests on
    a machine without a GPU).
    """
    if real_valued:
        raise ValueError("the Triton block trainer implements complex methods")
    if method not in BLOCK_METHODS:
        raise ValueError("the Triton block trainer implements %s, not %r"
                         % (BLOCK_METHODS, method))
    bad = check_shapes(TrSyms, block_size)
    if bad:
        raise ValueError(bad[0])
    grid = None
    if method in _DECISION_METHODS:
        from qampy_tpu.ops.phase import detect_grid, grid_decision_info
        syms = np.asarray(symbols)
        grid = detect_grid(syms[0])
        kind = grid_decision_info(grid)[0]
        if kind not in ("sq", "x", "r", "gen"):
            raise ValueError("no decision for grid kind %r" % kind)
        if kind == "gen" and syms.shape[-1] > MAX_GEN_POINTS:
            raise ValueError("the unrolled decision takes alphabets of up "
                             "to %d points" % MAX_GEN_POINTS)
    return _train_impl(E, TrSyms, Niter, os, mu, wx, symbols, method,
                       bool(adaptive), int(block_size), bool(interpret), grid,
                       _CHUNK, _NUM_WARPS, _NUM_STAGES)


@partial(jax.jit, static_argnames=("TrSyms", "Niter", "os", "method",
                                   "adaptive", "block_size", "interpret",
                                   "grid", "chunk", "num_warps",
                                   "num_stages"))
def _train_impl(E, TrSyms, Niter, os, mu, wx, symbols, method, adaptive,
                block_size, interpret, grid, chunk, num_warps, num_stages):
    E = jnp.asarray(E)
    wx = jnp.asarray(wx)
    symbols = jnp.asarray(symbols)
    nmodes = E.shape[0]
    nout, _, ntaps = wx.shape
    S = min(block_size, TrSyms)
    nblocks = TrSyms // S
    nsteps = Niter * nblocks
    C = min(S, chunk)
    K = nmodes * ntaps
    Kp = _next_pow2(K)
    ncode = (symbols.shape[-1] + 1) // 2 if method == "rde" else 1
    nc = symbols.shape[-1] if method == "rde" else 1
    ncp = _next_pow2(max(nc, 2))
    f32 = jnp.float32

    # windows with Kp-K zero rows (power-of-two tiles, zero taps)
    Xw = training_windows(E, nblocks * S, os, ntaps)
    Xw = jnp.pad(Xw, ((0, Kp - K), (0, 0)))
    w2 = jnp.pad(jnp.moveaxis(wx, -1, 1).reshape(nout, K),
                 ((0, 0), (0, Kp - K)))
    consts = jnp.zeros((nout, ncp), symbols.dtype)
    if method not in _DECISION_METHODS:
        consts = consts.at[:, :nc].set(symbols[:, :nc])
    mu0 = jnp.full((nout, 2), mu, f32)

    def kernel(xr_ref, xi_ref, w0r_ref, w0i_ref, cr_ref, ci_ref, mu_ref,
               wr_ref, wi_ref, mu_out_ref, er_ref, ei_ref):
        # er/ei hold the error trace one column late: column 0 is the zero
        # "error before the first symbol", column 1 + b*S + s the error of
        # symbol s of step b
        m = pl.program_id(0)
        lane_c = lax.broadcasted_iota(jnp.int32, (ncp,), 0)
        crow, cirow = cr_ref[m, :], ci_ref[m, :]
        cr = [jnp.sum(jnp.where(lane_c == j, crow, 0.0)) for j in range(nc)]
        ci = [jnp.sum(jnp.where(lane_c == j, cirow, 0.0)) for j in range(nc)]
        errfn = _error_fn(method, grid, cr, ci, ncode)
        lane = lax.broadcasted_iota(jnp.int32, (C,), 0)
        mu_c = jnp.sum(jnp.where(lax.broadcasted_iota(jnp.int32, (2,), 0)
                                 == 0, mu_ref[m, :], 0.0))
        er_ref[m, pl.ds(0, C)] = jnp.zeros((C,), f32)
        ei_ref[m, pl.ds(0, C)] = jnp.zeros((C,), f32)

        def step(b, carry):
            wr, wi, mu_c = carry
            blk = lax.rem(b, nblocks)
            dwr = jnp.zeros((Kp,), f32)
            dwi = jnp.zeros((Kp,), f32)
            fsum = jnp.zeros((), f32)
            for c in range(S // C):
                col = blk * S + c * C            # first training symbol
                out = 1 + b * S + c * C          # its error-trace column
                xr = xr_ref[:, pl.ds(col, C)]
                xi = xi_ref[:, pl.ds(col, C)]
                # z = w . X over the (Kp, C) window tile, split planes
                zr = jnp.sum(wr[:, None] * xr - wi[:, None] * xi, axis=0)
                zi = jnp.sum(wr[:, None] * xi + wi[:, None] * xr, axis=0)
                er, ei = errfn(zr, zi)
                er_ref[m, pl.ds(out, C)] = er
                ei_ref[m, pl.ds(out, C)] = ei
                ger, gei = er * mu_c, ei * mu_c
                # w += mu * err . conj(X): summed over the block
                dwr = dwr + jnp.sum(xr * ger[None, :] + xi * gei[None, :],
                                    axis=1)
                dwi = dwi + jnp.sum(xr * gei[None, :] - xi * ger[None, :],
                                    axis=1)
                if adaptive:
                    # the PREVIOUS symbol's error, read back one column
                    # early from the trace just written (adapt_step(mu,
                    # err[i], err[i-1]) shrinks by its second argument,
                    # pythran_equalisation.py:12-22); the barrier makes
                    # every thread's stores visible first
                    if not interpret:
                        pltriton.debug_barrier()
                    qr = er_ref[m, pl.ds(out - 1, C)]
                    qi = ei_ref[m, pl.ds(out - 1, C)]
                    keep = (er * qr > 0) & (ei * qi > 0)
                    # the i > 0 gate (:171) skips the pass's first symbol
                    flip = jnp.logical_not(keep) & (col + lane > 0)
                    fsum = fsum + jnp.sum(jnp.where(flip, qr * qr + qi * qi,
                                                    0.0))
            wr, wi = wr + dwr, wi + dwi
            if adaptive:
                # chained mu <- mu/(1+mu*e) == 1/mu += e over flip symbols
                mu_c = 1.0 / (1.0 / mu_c + fsum)
            return wr, wi, mu_c

        wr, wi, mu_c = lax.fori_loop(
            0, nsteps, step, (w0r_ref[m, :], w0i_ref[m, :], mu_c))
        wr_ref[m, :] = wr
        wi_ref[m, :] = wi
        mu_out_ref[m, :] = jnp.zeros((2,), f32) + mu_c

    sds = jax.ShapeDtypeStruct
    wr, wi, mu_f, er, ei = pl.pallas_call(
        kernel,
        grid=(nout,),
        out_shape=(sds((nout, Kp), f32), sds((nout, Kp), f32),
                   sds((nout, 2), f32), sds((nout, 1 + nsteps * S), f32),
                   sds((nout, 1 + nsteps * S), f32)),
        backend="triton",
        compiler_params=pltriton.CompilerParams(num_warps=num_warps,
                                                num_stages=num_stages),
        interpret=interpret,
        name="block_lms_trainer",
    )(Xw.real.astype(f32), Xw.imag.astype(f32),
      w2.real.astype(f32), w2.imag.astype(f32),
      consts.real.astype(f32), consts.imag.astype(f32), mu0)
    wout = jnp.moveaxis((wr[:, :K] + 1j * wi[:, :K]).reshape(nout, ntaps,
                                                             nmodes),
                        1, -1).astype(E.dtype)
    err = (er[:, 1:] + 1j * ei[:, 1:]).astype(E.dtype)
    return err, wout, mu_f[:, 0]

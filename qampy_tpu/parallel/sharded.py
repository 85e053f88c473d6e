"""Time-sharded DSP kernels via shard_map + collectives.

The waveform time axis is sharded across the mesh; FIR filtering needs an
(ntaps-1)-sample halo from the right neighbour and BPS an N-sample halo on
both sides — fetched with ``lax.ppermute`` (neighbour exchange),
exactly the overlap-save pattern the reference uses for chunked GPU BPS
(core/phaserecovery.py:184-205) but expressed as mesh collectives. Phase
unwrap across shard boundaries is made exact with an all-gather of boundary
phases and a per-device offset correction. Equaliser training runs
data-parallel over local time blocks with ``pmean`` tap averaging.

Boundary semantics are circular (the first/last devices exchange wrap-around
halos); for the long waveforms this targets, the O(ntaps) wrap region is
statistically negligible and keeps all shapes static and equal per shard.
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import PartitionSpec as P

from qampy_tpu.parallel.mesh import TIME, make_mesh
from qampy_tpu.ops import equaliser as eqops
from qampy_tpu.ops import phase as phops
from qampy_tpu.helpers import cabssquared


def _halo_from_right(x, n):
    """Append the first n samples of the right neighbour (circular)."""
    ndev = lax.axis_size(TIME)
    perm = [(i, (i - 1) % ndev) for i in range(ndev)]
    halo = lax.ppermute(x[..., :n], TIME, perm)
    return jnp.concatenate([x, halo], axis=-1)


def _halo_from_left(x, n):
    """Prepend the last n samples of the left neighbour (circular)."""
    ndev = lax.axis_size(TIME)
    perm = [(i, (i + 1) % ndev) for i in range(ndev)]
    halo = lax.ppermute(x[..., -n:], TIME, perm)
    return jnp.concatenate([halo, x], axis=-1)


def _apply_filter_local(E_loc, os, wxy):
    """Filter a local shard with a right halo so outputs tile exactly.

    Output length is Lloc//os per shard (the halo supplies the ntaps-1
    lookahead the VALID conv would otherwise lose).
    """
    ntaps = wxy.shape[-1]
    Ee = _halo_from_right(E_loc, ntaps - 1 + os)
    out = eqops.apply_filter_to_signal(Ee, os, wxy)
    return out[..., : E_loc.shape[-1] // os]


def _unwrap_across_shards(ph4):
    """Global unwrap of a sharded phase sequence (values pre-multiplied by 4).

    Local unwrap + boundary offset correction: offsets are multiples of 2*pi
    accumulated left-to-right over shards, computed from all-gathered
    boundary samples with a tiny device-count loop.
    """
    ndev = lax.axis_size(TIME)
    loc = jnp.unwrap(ph4, axis=-1)
    lasts = lax.all_gather(loc[..., -1], TIME)   # (ndev, ...)
    firsts = lax.all_gather(loc[..., 0], TIME)   # (ndev, ...)
    two_pi = 2 * np.pi

    def body(d, offs):
        # total discontinuity between the (already offset) end of shard d-1
        # and the raw local start of shard d, snapped to a 2*pi multiple
        jump = lasts[d - 1] + offs[d - 1] - firsts[d]
        k = jnp.round(jump / two_pi)
        return offs.at[d].set(k * two_pi)

    offs0 = lax.pcast(jnp.zeros((ndev,) + loc.shape[:-1], dtype=loc.dtype),
                      (TIME,), to='varying')
    offs = lax.fori_loop(1, ndev, body, offs0)
    my = lax.axis_index(TIME)
    return loc + offs[my][..., None]


def _bps_local(E_loc, angles, symbols, N, grid=None):
    """BPS on a local shard with N-sample halos on both sides.

    Every local sample gets a full 2N averaging window; the per-sample angle
    indices are identical to the unsharded kernel away from the global edges.
    """
    Ee = _halo_from_left(_halo_from_right(E_loc, N), N)

    def one_mode(e):
        idx = phops.bps_idx(e, angles, symbols, N, grid=grid)
        return phops.select_angles(angles, idx)

    ph = jax.vmap(one_mode)(Ee)
    ph = ph[..., N:-N] if N > 0 else ph
    ph = _unwrap_across_shards(ph * 4) / 4
    return E_loc * jnp.exp(1.j * ph).astype(E_loc.dtype), ph


def _bps_local_decimated(Eeq, angles, symbols, grid, N, dec):
    """Per-shard DECIMATED carrier recovery (ops/chain bps_mode=
    'decimated<dec>'): the full-window BPS runs on every dec-th equalised
    symbol of the shard with ``N``-sample halos in the decimated domain
    (N*dec symbols of context), the decimated phase is unwrapped exactly
    across shards, a one-block right halo of the unwrapped phase gives the
    interpolation slope, and the shard is derotated by the
    piecewise-linear phase. The last shard's tail block keeps a zero slope,
    as the single-device chain does."""
    Lout = Eeq.shape[-1]
    if Lout % dec:
        raise ValueError("per-shard symbol count %d must divide the "
                         "decimation stride %d" % (Lout, dec))
    Ed = Eeq[:, ::dec]
    Ee = _halo_from_left(_halo_from_right(Ed, N), N)
    idx = jax.vmap(lambda e: phops.bps_idx(e, angles, symbols, N,
                                           grid=grid))(Ee)
    A = angles.shape[-1]
    phd = (-np.pi / 4) + (np.pi / 2 / A) * idx[:, N:-N].astype(jnp.float32)
    # exact cross-shard pi/2 unwrap on the decimated phase
    phu = _unwrap_across_shards(phd * 4) / 4
    # slope: the next decimated phase — the last block needs the LEFT edge
    # of the right neighbour; the global tail block has none (zero slope)
    ndev = lax.axis_size(TIME)
    perm = [(i, (i - 1) % ndev) for i in range(ndev)]
    nxt = lax.ppermute(phu[:, :1], TIME, perm)              # (no, 1)
    nxt = jnp.where(lax.axis_index(TIME) == ndev - 1, phu[:, -1:], nxt)
    slope = (jnp.concatenate([phu[:, 1:], nxt], axis=-1) - phu) / dec
    ph = phops.interp_blocks(phu, slope, dec, Lout)
    return phops.derotate(Eeq, ph), phu


def _train_parallel(E_loc, os, mu, w0, symbols, method, Niter, TrSyms_loc,
                    adaptive, rounds, block_size, train):
    """Data-parallel block-LMS: local training + ``pmean`` tap averaging.

    Each device trains on its own time block with ``train`` (the XLA or
    the hand-written block trainer), starting from its own ``w0``. Taps
    trained on different blocks differ by the carrier phase of each block
    (blind criteria are phase blind up to the constellation's symmetry, and
    the carrier walks between blocks), so every device's taps are aligned
    to device 0's phase before the average, which is otherwise destructive.
    The next round starts from the average turned back into the device's
    own phase: a decision-directed stage started in another block's phase
    frame can diverge. For a stationary channel this converges like
    training on the concatenated sequence while every device works in
    parallel. Returns ``(w_common, w_local)``: the average in device 0's
    phase (for the filter, so the carrier phase stays continuous across
    shards) and the same taps in the device's own phase (to start a next
    stage).
    """
    w = w0
    for _ in range(rounds):
        _, w_new, _ = train(E_loc, TrSyms_loc, Niter, os, mu, w, symbols,
                            method, adaptive=adaptive, block_size=block_size)
        w_ref = lax.all_gather(w_new, TIME)[0]
        inner = jnp.sum(w_new * jnp.conj(w_ref), axis=(-2, -1), keepdims=True)
        phase = inner / jnp.maximum(jnp.abs(inner), 1e-12)
        w_common = lax.pmean(w_new * jnp.conj(phase), TIME)
        w = w_common * phase
    return w_common, w


def make_sharded_rx_chain(mesh, os, mu1, mu2, M, Ntaps, methods=("cma", "rde"),
                          TrSyms_loc=None, Niter=1, bps_angles=32, bps_N=16,
                          rounds=2, block_size=64, adaptive=True, pallas=None,
                          symbols=None, bps_mode="single"):
    """Build the jitted multi-device blind RX chain.

    Input: (nmodes, L) waveform sharded over time; runs two-stage
    equalisation (data-parallel training with pmean tap averaging), sharded
    filter application with halo exchange, sharded BPS with halo exchange
    and cross-shard unwrap, and psum-reduced quality metrics.
    ``bps_mode`` is ``"single"`` or ``"decimated"``/``"decimated<k>"``
    (ops/chain.make_rx_chain). ``pallas`` selects the hand-written block
    trainer per shard exactly as make_rx_chain does (ops/_backend.py).

    ``symbols`` overrides the constellation with an arbitrary host
    alphabet, mirroring make_rx_chain(symbols=...): blind constants come
    from the alphabet's moments and the BPS searches the alphabet.

    Returns a function f(E) -> (Eout, ph, evm) where Eout is
    the equalised + derotated symbol-rate signal (sharded over time).
    """
    dtype = np.complex64
    from qampy_tpu.theory import cal_symbols_qam, cal_scaling_factor_qam
    from qampy_tpu.ops import _backend
    from qampy_tpu.ops.chain import (pallas_eligibility, split_collapsed_rows,
                                     _decimation)
    if not (bps_mode == "single" or bps_mode.startswith("decimated")):
        raise ValueError("sharded chain bps_mode is 'single' or "
                         "'decimated<k>', got %r" % (bps_mode,))
    if symbols is not None:
        const = np.asarray(symbols).astype(dtype).reshape(-1)
        M = const.shape[0]
        symbols1 = np.tile(eqops.generate_symbols_for_eq_from_alphabet(
            methods[0], const, dtype), (2, 1))
        symbols2 = np.tile(eqops.generate_symbols_for_eq_from_alphabet(
            methods[1], const, dtype), (2, 1))
    else:
        symbols1 = eqops._reshape_symbols(None, methods[0], M, dtype, 2)
        symbols2 = eqops._reshape_symbols(None, methods[1], M, dtype, 2)
        const = (cal_symbols_qam(M) / np.sqrt(cal_scaling_factor_qam(M))).astype(dtype)
    grid = phops.detect_grid(const)
    _, reasons = pallas_eligibility(grid, methods, block_size, TrSyms_loc)
    use_kernel = _backend.use_kernel(pallas, reasons,
                                     what="sharded rx chain")
    if use_kernel:
        from qampy_tpu.ops.trainer_triton import \
            train_equaliser_block_triton as train
    else:
        train = eqops.train_equaliser_block
    angles = np.linspace(-np.pi / 4, np.pi / 4, bps_angles, endpoint=False,
                         dtype=np.float32).reshape(1, -1)

    def chain(E_loc):
        nmodes = E_loc.shape[0]
        w0 = jnp.asarray(eqops._init_taps(Ntaps, nmodes, nmodes, dtype))
        trs = TrSyms_loc if TrSyms_loc is not None else (E_loc.shape[-1] - Ntaps) // os
        # seed: device 0's stage-1 taps on every device, so that all
        # devices assign the output rows to the same source polarisations
        # (blind training from the initial taps may pair them differently
        # per block, and no average undoes a swap)
        _, w1, _ = train(E_loc, trs, Niter, os, mu1, w0, symbols1,
                         methods[0], adaptive=adaptive, block_size=block_size)
        w1 = split_collapsed_rows(lax.all_gather(w1, TIME)[0])
        _, w1 = _train_parallel(E_loc, os, mu1, w1, symbols1, methods[0],
                                Niter, trs, adaptive, rounds, block_size,
                                train)
        w2, _ = _train_parallel(E_loc, os, mu2, w1, symbols2, methods[1],
                                Niter, trs, adaptive, rounds, block_size,
                                train)
        Eeq = _apply_filter_local(E_loc, os, w2)
        if bps_mode.startswith("decimated"):
            Eout, ph = _bps_local_decimated(Eeq, jnp.asarray(angles), const,
                                            grid, bps_N,
                                            _decimation(bps_mode))
        else:
            Eout, ph = _bps_local(Eeq, jnp.asarray(angles), jnp.asarray(const),
                                  bps_N, grid=grid)
        # psum-reduced EVM against decisions
        from qampy_tpu.core.metrics import decision_idx
        det = jnp.asarray(const)[decision_idx(Eout, jnp.asarray(const))]
        sq = jnp.sum(cabssquared(Eout - det))
        n = Eout.size
        evm = jnp.sqrt(lax.psum(sq, TIME) / lax.psum(jnp.float32(n), TIME))
        return Eout, ph, evm

    # check_vma=False: a pallas_call's outputs do not declare varying-axes
    # types (jax 0.9); the collectives here are explicit and the chain is
    # numerically tested on the virtual mesh, so the static vma check adds
    # nothing
    smapped = jax.shard_map(chain, mesh=mesh,
                            in_specs=P(None, TIME),
                            out_specs=(P(None, TIME), P(None, TIME), P()),
                            check_vma=False)
    jitted = jax.jit(smapped)

    # jit wrappers reject attribute assignment; expose backend_info on a
    # thin callable instead
    def chain_fn(E):
        return jitted(E)

    chain_fn.backend_info = {"family": (_backend.family() if use_kernel
                                        else "xla"),
                             "pallas": bool(use_kernel), "reasons": reasons,
                             "methods": tuple(methods), "bps_mode": bps_mode}
    chain_fn.jitted = jitted
    return chain_fn


def shard_signal(E, mesh, spec=None):
    """Build a (nmodes, L) global array sharded over the time axis.

    Works in both single-process and multi-process (multi-controller)
    mode: with >1 process each process materialises only its addressable
    shards from the (identical) host array via
    ``jax.make_array_from_callback``; single-process it is a plain
    ``device_put``. ``spec`` overrides the default time sharding (pass
    ``P()`` via :func:`replicate_signal` for broadcast inputs).
    """
    if spec is None:
        spec = P(None, TIME)
    sharding = jax.sharding.NamedSharding(mesh, spec)
    if jax.process_count() > 1:
        E = np.asarray(E)
        return jax.make_array_from_callback(E.shape, sharding,
                                            lambda idx: E[idx])
    return jax.device_put(E, sharding)


def replicate_signal(E, mesh):
    """Global fully-replicated array from an identical-per-process host array."""
    return shard_signal(E, mesh, spec=P(*([None] * np.ndim(E))))


def fetch_global(x, mesh):
    """Host numpy copy of a (possibly multi-host-sharded) global array.

    Re-shards to fully-replicated (an all-gather over the mesh), making
    every shard addressable on every process, then fetches. This is the
    multi-process-safe way to SER-gate a sharded chain's output.
    """
    rep = jax.jit(lambda v: v,
                  out_shardings=jax.sharding.NamedSharding(mesh, P()))(x)
    return np.asarray(rep)


def make_sharded_pilot_rx(mesh, pilot_seq, ph_pilots, frame_len,
                          pilot_ins_rat, frames_per_device,
                          shard_prefix=False, **chain_kwargs):
    """Frame-data-parallel pilot receiver over the mesh.

    The pilot receiver's natural multi-chip axis is FRAMES, not time:
    after one frame sync + pilot-sequence training, every frame of the
    capture is demodulated independently with the shared taps. Each
    device demodulates its own ``frames_per_device`` contiguous frames;
    the only cross-device dependency is the broadcast capture, so scaling
    efficiency is bounded only by the cold-start prefix fraction
    (Amdahl), not by per-sample communication.

    ``shard_prefix=False`` runs the sync + two-stage training replicated
    (identical on every device). ``shard_prefix=True`` DISTRIBUTES the
    cold-start prefix too (ops/pilot_chain ``prefix_sharded``): the W
    candidate-window sync trainings are split across devices (only tiny
    min/index/tap arrays are all-gathered), and the per-mode alignment +
    pilot trainings run on device groups — the per-device prefix cost
    drops ~1/ndev for the search instead of staying constant. Requires
    ndev >= nmodes and foe_comp=False.

    Parity: the single-chip fused chain (ops/pilot_chain.py) which itself
    mirrors reference core/pilotbased_receiver.py:329-554 + :258-327; the
    reference has no multi-frame parallel path (its
    ``pilot_equaliser_nframes`` loops frames on the host,
    qampy/equalisation.py:340-397).

    Returns ``f(E) -> (data, shift, sync_corr)`` where ``E`` is the full
    (nmodes, L) capture (replicated) and ``data`` is
    (nmodes, ndev*frames_per_device*n_data) with frames in device order.
    """
    from qampy_tpu.ops.pilot_chain import make_pilot_rx_chain

    ndev = mesh.devices.size
    k = int(frames_per_device)
    if shard_prefix:
        # the distributed cold-start defaults to the closed-form LS
        # pilot trainer: the per-mode LMS training is a chain of serial
        # block steps that sharding across modes barely shortens, while
        # LS is one Gram matmul + solve per mode at equal or better
        # quality. Pass eq_trainer="lms" explicitly to keep the iterative
        # trainer.
        chain_kwargs.setdefault("eq_trainer", "ls")
    # the per-device chain demodulates frames [0, k) of a capture whose
    # origin is offset by axis_index*k frames
    fwd = make_pilot_rx_chain(pilot_seq, ph_pilots, frame_len,
                              pilot_ins_rat, frames=tuple(range(k)),
                              **chain_kwargs)
    os_ = chain_kwargs.get("os", 2)

    def local(E):
        d = lax.axis_index(TIME)
        # shift this device's frame window to the capture start: frame f
        # on device d is global frame d*k + f. Only the demodulation
        # offsets differ per device; the acquired state is identical.
        if shard_prefix:
            taps, shift, mode_order, sync_corr, _ = fwd.prefix_sharded(
                E.real, E.imag, TIME, ndev)
            data, _ = fwd.tracking(E, taps, shift, mode_order=mode_order,
                                   _frame_base=d * k * frame_len * os_)
            return data, shift, sync_corr[None]
        data, info = fwd(E, _frame_base=d * k * frame_len * os_)
        return data, info["shift"], info["sync_corr"][None]

    smapped = jax.shard_map(local, mesh=mesh,
                            in_specs=P(None, None),
                            out_specs=(P(None, TIME), P(TIME), P(TIME)),
                            check_vma=False)
    jitted = jax.jit(smapped)

    def chain_fn(E):
        return jitted(E)

    def local_tracking(E, taps, shift, mode_order):
        d = lax.axis_index(TIME)
        data, _ = fwd.tracking(E, taps, shift, mode_order=mode_order,
                               _frame_base=d * k * frame_len * os_)
        return data

    tr_smapped = jax.shard_map(
        local_tracking, mesh=mesh,
        in_specs=(P(None, None), P(None, None, None), P(None), P(None)),
        out_specs=P(None, TIME), check_vma=False)
    tr_jitted = jax.jit(tr_smapped)

    def tracking(E, taps, shift, mode_order):
        """Frame-parallel STEADY-STATE serving: demodulate ndev*k frames
        with taps/shift/mode_order from a previous full dispatch — the
        replicated sync+train prefix (the Amdahl term bounding the full
        chain's frame-parallel efficiency) disappears entirely."""
        return tr_jitted(E, jnp.asarray(taps), jnp.asarray(shift),
                         jnp.asarray(mode_order))

    chain_fn.tracking = tracking
    chain_fn.backend_info = dict(fwd.backend_info, ndev=ndev,
                                 frames_per_device=k,
                                 shard_prefix=bool(shard_prefix))
    chain_fn.jitted = jitted
    return chain_fn

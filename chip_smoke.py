"""Chip smoke: both served receivers once on the GPU, checked.

Run from the repository root::

    python chip_smoke.py          # one GPU: every phase below
    python chip_smoke.py --four   # four GPUs: the sharded receivers only

Phases (one line or more each; any failure exits non-zero):

1. card and cache: the card's name and power limit from ``nvidia-smi``
   (a child process that stays off JAX), the JAX version, the compile
   cache directory; then the tests marked ``gpu`` in a child pytest that
   finishes before this process opens the card;
2. kernels: the hand-written block trainer compiled at the bench shapes
   and compared with XLA's trainer, with memory analysis and times; the
   XLA times of the stages that replaced hand-written kernels, and the
   filter's precision;
3. blind chain on the bench capture: ``decimated16``, ``single`` and the
   tracking entry, each held to the bench SER gate;
4. pilot chain on the bench's 244-frame capture at 240 frames per
   dispatch: LS and LMS trainers and the tracking entry, each held to the
   BER and sync gates.

``--four`` builds a 1-D mesh over four cards and runs the time-sharded
blind chain (``single`` and ``decimated``) and the frame-parallel pilot
receiver with its tracking entry, each gated and compared with the
single-device chain on the same capture.

The last line of standard output is one JSON object with the device as
JAX reports it. Times are smoke, not a benchmark (bench.py measures).
"""
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))


def card_line():
    """``name, power.limit`` of the first card from nvidia-smi."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def gpu_tests():
    """Run the tests marked ``gpu`` in a child process on the card."""
    env = dict(os.environ, JAX_PLATFORMS="cuda")
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "tests", "-m", "gpu", "-q",
         "-p", "no:cacheprovider", "-rs"], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=900)
    tail = proc.stdout.strip().splitlines()[-1:] or [""]
    print("gpu tests: rc=%d %s" % (proc.returncode, tail[0]), flush=True)
    # a module-level skip elsewhere (e.g. no reference tree) is not a
    # failure; a gpu test that skips (the fixture found no card) or fails is
    if (proc.returncode != 0 or " passed" not in tail[0]
            or "needs a GPU" in proc.stdout):
        print(proc.stdout[-6000:], proc.stderr[-3000:], flush=True)
        raise RuntimeError("gpu-marked tests failed")


def timed(f, *args):
    """Median seconds of ``f(*args)`` after a warm-up call (bench.timed)."""
    import bench
    return bench.timed(f, *args)[0]


def check(ok, what):
    if not ok:
        raise RuntimeError("check failed: " + what)


def phase_kernels(E, TrSyms=2 ** 14, block_size=256):
    """Block trainer kernel vs XLA at the bench shapes (MCMA then MDDMA),
    and XLA times of the stages whose hand-written kernels went."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax import lax
    from qampy_tpu.ops import equaliser as eqops
    from qampy_tpu.ops import phase as phops
    from qampy_tpu.ops.trainer_triton import train_equaliser_block_triton
    w = jnp.asarray(eqops._init_taps(17, 2, 2, np.complex64))
    Ed = jax.device_put(E)
    for method in ("mcma", "mddma"):
        syms = eqops._reshape_symbols(None, method, 64, np.complex64, 2)
        kw = dict(adaptive=True, block_size=block_size)
        kern = jax.jit(lambda e, w0, s=syms, m=method: train_equaliser_block_triton(
            e, TrSyms, 1, 2, 1.9e-3, w0, s, m, **kw))
        ref = jax.jit(lambda e, w0, s=syms, m=method: eqops.train_equaliser_block(
            e, TrSyms, 1, 2, 1.9e-3, w0, s, m, **kw))
        mem = kern.lower(Ed, w).compile().memory_analysis()
        _, wk, muk = kern(Ed, w)
        _, wr, mur = ref(Ed, w)
        dw = float(jnp.max(jnp.abs(wk - wr)) / jnp.max(jnp.abs(wr)))
        tk, tr = timed(kern, Ed, w), timed(ref, Ed, w)
        print("kernel trainer %s: max|dw|/max|w|=%.2e mu %.4e/%.4e  "
              "kernel %.3f ms  xla %.3f ms  mem %s"
              % (method, dw, float(muk[0]), float(mur[0]), tk * 1e3,
                 tr * 1e3, mem), flush=True)
        # decision flips on near-threshold symbols under another summation
        # order move a tap by ~mu*|e*x|; 1e-2 of the tap scale bounds a few
        check(dw < 1e-2, "trainer kernel vs XLA (%s)" % method)
        w = wr
    # the exact per-sample trainer (the seq scan) that replaced the
    # per-sample kernel, on the same prefix
    syms = eqops._reshape_symbols(None, "mcma", 64, np.complex64, 2)
    seq = jax.jit(lambda e, w0: eqops.train_equaliser_seq(
        e, TrSyms, 1, 2, 1.9e-3, w0, syms, "mcma", adaptive=True))
    print("xla per-sample trainer (seq scan, mcma): %.3f ms"
          % (timed(seq, Ed, w) * 1e3), flush=True)
    # the filter in full float32 vs XLA's HIGH (TF32 on this card)
    Ef = jax.jit(lambda e, w_: eqops.apply_filter_to_signal(
        e, 2, w_, precision=lax.Precision.HIGHEST))
    Eh = jax.jit(lambda e, w_: eqops.apply_filter_to_signal(
        e, 2, w_, precision=lax.Precision.HIGH))
    yf, yh = Ef(Ed, w), Eh(Ed, w)
    err = float(jnp.max(jnp.abs(yh - yf)) / jnp.sqrt(jnp.mean(jnp.abs(yf) ** 2)))
    print("xla filter: HIGHEST %.3f ms  HIGH %.3f ms  max|HIGH-HIGHEST|/rms "
          "%.2e" % (timed(Ef, Ed, w) * 1e3, timed(Eh, Ed, w) * 1e3, err),
          flush=True)
    const = jnp.asarray(eqops.generate_symbols_for_eq("dd", 64, np.complex64)[0])
    grid = phops.detect_grid(np.asarray(const))
    ang = jnp.linspace(-np.pi / 4, np.pi / 4, 64, endpoint=False,
                       dtype=jnp.float32).reshape(1, -1)
    bps = jax.jit(lambda y: jax.vmap(lambda e: phops.bps_idx(
        e, ang, const, 14, grid=grid))(y))
    bps16 = jax.jit(lambda y: jax.vmap(lambda e: phops.bps_idx(
        e, ang, const, 12, grid=grid))(y[:, ::16]))
    two = jax.jit(lambda y: phops.bps_twostage(y, 16, const, 14, B=8,
                                               N1=60)[1])
    ph = jnp.asarray(np.random.default_rng(0).uniform(
        -np.pi / 4, np.pi / 4, yf.shape).astype(np.float32))
    derot = jax.jit(lambda y, p: phops.derotate(y, phops.unwrap_quarter(p)))
    phd = ph[:, ::16]
    interp = jax.jit(lambda y, p: phops.derotate(y, phops.interp_blocks(
        p, jnp.pad(p[:, 1:] - p[:, :-1], ((0, 0), (0, 1))) / 16, 16,
        y.shape[-1])))
    print("xla stages (2x%d symbols): bps %.3f ms  bps-decimated16 %.3f ms  "
          "bps-twostage %.3f ms  unwrap+derotate %.3f ms  "
          "interp+derotate %.3f ms"
          % (yf.shape[-1], timed(bps, yf) * 1e3, timed(bps16, yf) * 1e3,
             timed(two, yf) * 1e3, timed(derot, yf, ph) * 1e3,
             timed(interp, yf, phd) * 1e3), flush=True)


def phase_blind(E, syms, const):
    """Blind chain: decimated16 and single, then the tracking entry."""
    import jax
    import numpy as np
    import bench
    P = jax.device_put(np.concatenate([E.real, E.imag]).astype(np.float32))
    symsd = jax.device_put(syms)
    nsym = E.shape[0] * syms.shape[-1]
    chains = {}
    for mode in ("decimated16", "single"):
        fwd = chains[mode] = bench.blind_chain(mode)
        run = jax.jit(fwd.planes)
        t0 = time.perf_counter()
        outr, outi = jax.block_until_ready(run(P))
        tc = time.perf_counter() - t0
        ser = bench.blind_ser(outr + 1j * outi, symsd, const)
        t = timed(run, P)
        print("blind %s [%s]: SER %.3e (gate %.0e)  %.1f Msym/s  "
              "first call %.1f s" % (mode, fwd.backend_info["family"], ser,
                                     bench.BLIND_SER_GATE, nsym / t / 1e6,
                                     tc), flush=True)
        check(ser <= bench.BLIND_SER_GATE, "blind %s SER" % mode)
    fwd = chains["decimated16"]
    (outr, outi), w2 = jax.jit(fwd.planes_with_taps)(P)
    trk = jax.jit(fwd.tracking_planes)
    tr, ti = trk(P, w2)
    ser = bench.blind_ser(tr + 1j * ti, symsd, const)
    diff = float(jax.numpy.max(jax.numpy.abs(tr - outr)))
    print("blind tracking (decimated16 taps): SER %.3e  max|tracking - full| "
          "%.2e  %.1f Msym/s" % (ser, diff, nsym / timed(trk, P, w2) / 1e6),
          flush=True)
    # same taps, same stages, compiled as another program
    check(diff <= 1e-4, "tracking vs full chain")
    check(ser <= bench.BLIND_SER_GATE, "blind tracking SER")


def phase_pilot(tx, nframes):
    """Pilot chain: LS and LMS trainers, then the tracking entry."""
    import jax
    import bench
    npay = tx["idx_tx"].shape[-1] * 2 * nframes
    for tr in ("ls", "lms"):
        fwd = bench.pilot_chain(tx, nframes, eq_trainer=tr)
        run = jax.jit(fwd.planes)
        t0 = time.perf_counter()
        (dr, di), info = jax.block_until_ready(run(tx["pr"], tx["pi"]))
        tc = time.perf_counter() - t0
        ber, ser = bench.pilot_ber(dr, di, tx)
        corr = float(info["sync_corr"])
        t = timed(run, tx["pr"], tx["pi"])
        print("pilot %s, %d frames: BER %.3e SER %.3e sync_corr %.1f  "
              "%.1f Msym/s  first call %.1f s"
              % (tr, nframes, ber, ser, corr, npay / t / 1e6, tc),
              flush=True)
        check(ber <= bench.PILOT_BER_GATE, "pilot %s BER" % tr)
        check(corr >= bench.SYNC_CORR_MIN, "pilot %s sync_corr" % tr)
    trk = jax.jit(fwd.tracking_planes)
    args = (tx["pr"], tx["pi"], info["taps"], info["shift"],
            info["mode_order"])
    (tr_, ti_), _ = trk(*args)
    ber, _ = bench.pilot_ber(tr_, ti_, tx)
    diff = float(jax.numpy.max(jax.numpy.abs(tr_ - dr)))
    print("pilot tracking (lms state): BER %.3e  max|tracking - full| %.2e  "
          "%.1f Msym/s" % (ber, diff, npay / timed(trk, *args) / 1e6),
          flush=True)
    check(ber <= bench.PILOT_BER_GATE, "pilot tracking BER")
    check(diff <= 1e-4, "tracking vs full chain")


def phase_four(E, syms, const, tx, frames_per_device, ndev=4):
    """Sharded receivers on an ``ndev`` mesh vs the single-device chains."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import bench
    from qampy_tpu.parallel import make_mesh, sharded
    mesh = make_mesh(ndev)
    print("mesh: %s" % (mesh.devices.tolist(),), flush=True)
    Es = sharded.shard_signal(E, mesh)
    symsd = jax.device_put(syms)
    nsym = E.shape[0] * syms.shape[-1]
    kw = {k: bench.BLIND_CHAIN[k] for k in ("M", "Ntaps", "os", "methods",
                                             "bps_angles", "block_size")}
    for mode in ("single", "decimated"):
        ch = sharded.make_sharded_rx_chain(
            mesh, mu1=1.9e-3, mu2=1.9e-3, TrSyms_loc=bench.BLIND_CHAIN["TrSyms"],
            rounds=2, bps_N=14, bps_mode=mode, **kw)
        Eout, _, evm = jax.block_until_ready(ch(Es))
        ser = bench.blind_ser(Eout, symsd, const)
        t = timed(ch, Es)
        fwd = bench.blind_chain(mode)
        P = jax.device_put(np.concatenate([E.real, E.imag]).astype(np.float32))
        o1r, o1i = jax.jit(fwd.planes)(P)
        ser1 = bench.blind_ser(o1r + 1j * o1i, symsd, const)
        print("sharded blind %s [%s] x%d: SER %.3e (single device %.3e)  "
              "evm %.4f  %.1f Msym/s" % (mode, ch.backend_info["family"],
                                         ndev, ser, ser1, float(evm),
                                         nsym / t / 1e6), flush=True)
        check(ser <= bench.BLIND_SER_GATE, "sharded blind %s SER" % mode)
        check(ser1 <= bench.BLIND_SER_GATE, "single blind %s SER" % mode)
    Erep = sharded.replicate_signal(
        np.asarray(tx["pr"] + 1j * tx["pi"]).astype(np.complex64), mesh)
    nframes = ndev * frames_per_device
    pch = sharded.make_sharded_pilot_rx(
        mesh, tx["seq"], tx["ph"], tx["frame_len"], tx["ins_rat"],
        frames_per_device=frames_per_device,
        **bench.pilot_chain_kwargs(tx, eq_trainer="lms"))
    data, shift, corr = jax.block_until_ready(pch(Erep))
    ber, _ = bench.pilot_ber(data.real, data.imag, tx)
    t = timed(pch, Erep)
    fwd = bench.pilot_chain(tx, nframes, eq_trainer="lms")
    (dr, di), info = jax.jit(fwd.planes)(tx["pr"], tx["pi"])
    diff = float(jnp.max(jnp.abs(np.asarray(data) - np.asarray(dr + 1j * di))))
    npay = tx["idx_tx"].shape[-1] * 2 * nframes
    print("sharded pilot x%d, %d frames: BER %.3e sync_corr %.1f  "
          "max|sharded - single| %.2e  %.1f Msym/s"
          % (ndev, nframes, ber, float(jnp.min(corr)), diff, npay / t / 1e6),
          flush=True)
    check(ber <= bench.PILOT_BER_GATE, "sharded pilot BER")
    check(float(jnp.min(corr)) >= bench.SYNC_CORR_MIN, "sharded pilot sync")
    # same frames, same taps, another device per frame range
    check(diff <= 1e-4, "sharded pilot vs single device")
    trk = pch.tracking(Erep, info["taps"], info["shift"], info["mode_order"])
    ber_t, _ = bench.pilot_ber(trk.real, trk.imag, tx)
    dt = float(jnp.max(jnp.abs(np.asarray(trk) - np.asarray(data))))
    t = timed(pch.tracking, Erep, info["taps"], info["shift"],
              info["mode_order"])
    print("sharded pilot tracking x%d: BER %.3e  max|tracking - full| %.2e  "
          "%.1f Msym/s" % (ndev, ber_t, dt, npay / t / 1e6), flush=True)
    check(ber_t <= bench.PILOT_BER_GATE, "sharded pilot tracking BER")
    check(dt <= 1e-4, "sharded tracking vs sharded full chain")


def main(argv):
    four = "--four" in argv
    try:
        card = card_line()
    except (OSError, subprocess.SubprocessError) as e:
        print("no GPU: nvidia-smi failed (%s)" % e, file=sys.stderr)
        return 1
    print("card: %s" % card, flush=True)
    if not four:
        gpu_tests()
    import jax
    import numpy as np
    sys.path.insert(0, ROOT)
    import bench
    from qampy_tpu import compile_cache
    cache = compile_cache.enable()
    devs = jax.devices()
    if devs[0].platform != "gpu" or len(devs) < (4 if four else 1):
        print("needs %d GPU(s), JAX found %s" % (4 if four else 1, devs),
              file=sys.stderr)
        return 1
    print("jax %s, %d x %s, compile cache %s"
          % (jax.__version__, len(devs), devs[0].device_kind, cache),
          flush=True)
    t0 = time.perf_counter()
    E, syms, const = bench.make_tx(bench.BLIND_NSYM)
    tx = bench.make_pilot_tx()
    jax.block_until_ready(tx["pr"])
    print("captures ready: blind %s, pilot %s (%.1f s)"
          % (E.shape, tx["pr"].shape, time.perf_counter() - t0), flush=True)
    if four:
        phase_four(E, syms, const, tx, bench.PILOT_DISPATCH // 4)
    else:
        phase_kernels(E)
        phase_blind(E, syms, const)
        phase_pilot(tx, bench.PILOT_DISPATCH)
    print("card: %s" % card)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

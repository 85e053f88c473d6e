"""Block trainer kernel vs XLA on the GPU: launch variants and the chains.

Times, at the bench shapes (2^20-symbol dual-pol 64-QAM capture, 17 taps,
2 samples/symbol, 2^14 training symbols, block 256):

* the Triton block trainer per launch variant (chunk columns, warps,
  pipeline stages) against XLA's block trainer, MCMA then MDDMA;
* the blind chain end to end with the kernel and with XLA's trainer, in
  turns (xla, kernel, kernel, xla), decimated16 and single.

Every line names the card. Run: python tools/trainer_ab.py
"""
import subprocess
import sys

sys.path.insert(0, ".")

import numpy as np
import jax
import jax.numpy as jnp

import bench
import qampy_tpu.ops.trainer_triton as tt
from qampy_tpu import compile_cache
from qampy_tpu.ops import equaliser as eqops

VARIANTS = [(128, 4, 1), (128, 4, 2), (64, 4, 2), (256, 8, 1), (256, 8, 2),
            (256, 4, 2), (128, 8, 2)]


def main():
    compile_cache.enable()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print("card:", card, flush=True)
    if jax.devices()[0].platform != "gpu":
        return 1
    default = tt._CHUNK, tt._NUM_WARPS, tt._NUM_STAGES
    E, syms, const = bench.make_tx(bench.BLIND_NSYM)
    Ed = jax.device_put(E)
    w0 = jnp.asarray(eqops._init_taps(17, 2, 2, np.complex64))
    trs = bench.BLIND_CHAIN["TrSyms"]
    for method in ("mcma", "mddma"):
        s = eqops._reshape_symbols(None, method, 64, np.complex64, 2)
        ref = jax.jit(lambda e, w: eqops.train_equaliser_block(
            e, trs, 1, 2, 1.9e-3, w, s, method, adaptive=True,
            block_size=256))
        wr = ref(Ed, w0)[1]
        print("trainer %s xla: %.3f ms" % (method, bench.timed(
            ref, Ed, w0)[0] * 1e3), flush=True)
        for chunk, warps, stages in VARIANTS:
            tt._CHUNK, tt._NUM_WARPS, tt._NUM_STAGES = chunk, warps, stages
            kern = jax.jit(lambda e, w: tt.train_equaliser_block_triton(
                e, trs, 1, 2, 1.9e-3, w, s, method, adaptive=True,
                block_size=256))
            try:
                wk = kern(Ed, w0)[1]
                dw = float(jnp.max(jnp.abs(wk - wr)) / jnp.max(jnp.abs(wr)))
                t = bench.timed(kern, Ed, w0)[0]
                print("trainer %s kernel chunk=%d warps=%d stages=%d: "
                      "%.3f ms  max|dw|/max|w| %.1e"
                      % (method, chunk, warps, stages, t * 1e3, dw),
                      flush=True)
            except Exception as e:  # a variant the compiler refuses
                print("trainer %s kernel chunk=%d warps=%d stages=%d: "
                      "refused (%s)" % (method, chunk, warps, stages,
                                        str(e)[:200]), flush=True)
        w0 = wr
    tt._CHUNK, tt._NUM_WARPS, tt._NUM_STAGES = default
    P = jax.device_put(np.concatenate([E.real, E.imag]).astype(np.float32))
    symsd = jax.device_put(syms)
    for mode in ("decimated16", "single"):
        runs = {p: jax.jit(bench.blind_chain(mode, pallas=p).planes)
                for p in (False, True)}
        for p in (False, True, True, False):
            o = runs[p](P)
            ser = bench.blind_ser(o[0] + 1j * o[1], symsd, const)
            med, best = bench.timed(runs[p], P, reps=10)
            print("chain %s trainer=%s: median %.3f ms  min %.3f ms  "
                  "%.1f Msym/s  SER %.2e" % (mode, "kernel" if p else "xla",
                                             med * 1e3, best * 1e3,
                                             2 * bench.BLIND_NSYM / med / 1e6,
                                             ser), flush=True)
    print("card:", card)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""qampy_tpu — an accelerator coherent optical communications DSP framework.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of QAMpy
(ChalmersPhotonicsLab/QAMpy): TX signal generation
(QAM/PSK/pilot frames, PRBS, pulse shaping, resampling), channel and
transceiver impairment models, adaptive MIMO equalisation, carrier and phase
recovery, the pilot-based receiver chain, and signal-quality metrics.

Unlike the reference (numpy + pythran-compiled C++ hot loops on a single CPU
node), everything here is built for accelerator execution (the GPU):

- signal objects are registered pytrees (not ndarray subclasses) so they pass
  through ``jax.jit``/``vmap``/``shard_map`` unchanged,
- the sequential LMS tap-update recurrence is offered both in exact
  ``lax.scan`` form and in a block-parallel (matmul) formulation, the
  latter also as one GPU kernel (ops/trainer_triton.py),
- the blind-phase-search distance kernel is one fused decision + cumsum,
- multi-device scaling uses ``jax.sharding.Mesh`` + ``shard_map`` with halo
  exchange collectives instead of shared-memory OpenMP.

Default dtype is complex64; complex128 is supported under
``jax.config.update("jax_enable_x64", True)`` for validation parity.
"""

__version__ = "0.1.0"

from qampy_tpu import theory, helpers, utils, prbs
from qampy_tpu import core, ops
from qampy_tpu.signals import (
    Signal,
    SignalQAMGrayCoded,
    QPSKfromBERT,
    SignalPSKGrayCoded,
    SymbolOnlySignal,
    ResampledQAM,
    SignalWithPilots,
    TDHQAMSymbols,
    RandomBits,
    PRBSBits,
)
from qampy_tpu import equalisation, phaserec, impairments, filtering, analog_frontend, io

"""Kernel layer: the hot DSP ops (equaliser training, BPS, pilots).

These replace the reference's pythran C++/OpenMP kernels
(core/equalisation/pythran_equalisation.py, core/pythran_dsp.py) with
XLA-first designs: ``lax.scan`` for the exact sequential recurrences, and
matmul/cumsum formulations for the fast paths; ops/_backend.py picks the
hand-written GPU kernels where the platform has them.
"""
from qampy_tpu.ops import equaliser, phase, pilots
from qampy_tpu.ops.chain import make_rx_chain

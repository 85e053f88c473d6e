"""Multi-device scale-out: mesh construction and time-sharded DSP.

The reference's parallelism is single-node OpenMP plus a bitrotted ZMQ
worker pool (SURVEY.md §2 #27); here scale-out is a ``jax.sharding.Mesh``
over the waveform time axis with ``shard_map`` kernels that exchange
filter/BPS halos (``ppermute``/``all_gather``) and reduce metrics
with ``psum``.
"""
from qampy_tpu.parallel.mesh import init_distributed, make_mesh, time_axis
from qampy_tpu.parallel import sharded

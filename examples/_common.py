"""Shared example bootstrap: puts the repo root on the import path.

Examples run on JAX's default device; set ``JAX_PLATFORMS=cpu`` to run
them on the host.
"""
import sys as _sys, pathlib as _pl
_sys.path.insert(0, str(_pl.Path(__file__).resolve().parents[1]))  # repo root

"""Generate the API reference (docs/api/*.md) from the package docstrings.

Dependency-free stand-in for the reference's Sphinx docs pipeline
(reference Makefile:24-27, .gitlab-ci.yml:1-18 building qampy.org): walks
the public qampy_tpu surface with ``inspect`` and renders one Markdown page
per module — module docstring, public functions (signature + docstring),
classes with their public methods/properties. Run via ``make docs``.
"""
from __future__ import annotations

import importlib
import inspect
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                os.pardir))

import jax

jax.config.update("jax_platforms", "cpu")

OUT = os.path.join(os.path.dirname(__file__), os.pardir, "docs", "api")

MODULES = [
    "qampy_tpu",
    "qampy_tpu.signals",
    "qampy_tpu.theory",
    "qampy_tpu.helpers",
    "qampy_tpu.utils",
    "qampy_tpu.prbs",
    "qampy_tpu.equalisation",
    "qampy_tpu.phaserec",
    "qampy_tpu.impairments",
    "qampy_tpu.filtering",
    "qampy_tpu.analog_frontend",
    "qampy_tpu.io",
    "qampy_tpu.profiling",
    "qampy_tpu.core.metrics",
    "qampy_tpu.core.sync",
    "qampy_tpu.core.filter",
    "qampy_tpu.core.resample",
    "qampy_tpu.core.special",
    "qampy_tpu.core.impairments",
    "qampy_tpu.core.analog_frontend",
    "qampy_tpu.core.digital_pre_compensation",
    "qampy_tpu.core.io",
    "qampy_tpu.core.pilotbased_transmitter",
    "qampy_tpu.ops.equaliser",
    "qampy_tpu.ops.trainer_triton",
    "qampy_tpu.ops.phase",
    "qampy_tpu.ops.pilots",
    "qampy_tpu.ops.chain",
    "qampy_tpu.compile_cache",
    "qampy_tpu.ops.pilot_chain",
    "qampy_tpu.parallel",
    "qampy_tpu.parallel.sharded",
    "qampy_tpu.native",
]


def _sig(obj):
    try:
        return str(inspect.signature(inspect.unwrap(obj)))
    except (ValueError, TypeError):
        return "(...)"


def _doc(obj, indent=""):
    d = inspect.getdoc(obj)
    if not d:
        return indent + "*(no docstring)*\n"
    return "\n".join(indent + line for line in d.splitlines()) + "\n"


def _is_public(name, obj, modname):
    if name.startswith("_"):
        return False
    m = getattr(obj, "__module__", modname)
    # keep re-exports in the package root, skip them elsewhere
    return modname == "qampy_tpu" or m == modname or m is None


def render_module(modname):
    mod = importlib.import_module(modname)
    lines = ["# `%s`" % modname, ""]
    if mod.__doc__:
        lines += [inspect.cleandoc(mod.__doc__), ""]
    funcs, classes, consts = [], [], []
    names = getattr(mod, "__all__", None) or sorted(vars(mod))
    seen = set()
    for name in names:
        if name in seen or not hasattr(mod, name):
            continue
        seen.add(name)
        obj = getattr(mod, name)
        if not _is_public(name, obj, modname):
            continue
        if inspect.isclass(obj):
            classes.append((name, obj))
        elif callable(obj):
            funcs.append((name, obj))
        elif isinstance(obj, (tuple, float, int, str)) and name.isupper():
            consts.append((name, obj))
    if consts:
        lines += ["## Constants", ""]
        for name, obj in consts:
            lines += ["- `%s = %r`" % (name, obj)]
        lines += [""]
    if funcs:
        lines += ["## Functions", ""]
        for name, obj in funcs:
            lines += ["### `%s%s`" % (name, _sig(obj)), "", _doc(obj)]
    if classes:
        lines += ["## Classes", ""]
        for name, cls in classes:
            lines += ["### `%s%s`" % (name, _sig(cls)), "", _doc(cls)]
            for mname, meth in sorted(vars(cls).items()):
                if mname.startswith("_"):
                    continue
                if isinstance(meth, property):
                    lines += ["#### `%s.%s` *(property)*" % (name, mname),
                              "", _doc(meth)]
                elif callable(meth) or isinstance(meth, (staticmethod,
                                                         classmethod)):
                    f = meth.__func__ if isinstance(
                        meth, (staticmethod, classmethod)) else meth
                    lines += ["#### `%s.%s%s`" % (name, mname, _sig(f)),
                              "", _doc(f)]
    return "\n".join(lines) + "\n"


def main():
    os.makedirs(OUT, exist_ok=True)
    index = ["# qampy_tpu API reference", "",
             "Generated from the package docstrings by `tools/gendocs.py` "
             "(`make docs`).", ""]
    for modname in MODULES:
        fname = modname.replace(".", "_") + ".md"
        try:
            text = render_module(modname)
        except Exception as e:  # pragma: no cover - surface build errors
            print("FAILED %s: %r" % (modname, e), file=sys.stderr)
            raise
        with open(os.path.join(OUT, fname), "w") as f:
            f.write(text)
        mod = importlib.import_module(modname)
        first = (inspect.cleandoc(mod.__doc__).splitlines()[0]
                 if mod.__doc__ else "")
        index.append("- [`%s`](%s) — %s" % (modname, fname, first))
    with open(os.path.join(OUT, "index.md"), "w") as f:
        f.write("\n".join(index) + "\n")
    print("wrote %d module pages to %s" % (len(MODULES) + 1,
                                           os.path.normpath(OUT)))


if __name__ == "__main__":
    main()

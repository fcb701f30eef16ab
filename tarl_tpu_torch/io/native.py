"""ctypes binding of the port's C++ MATSim parser (ports
``tarl_tpu/io/native.py``: ``available``, ``parse_network_native`` and
``parse_population_native``).

The parser is the port's own copy, ``tarl_tpu_torch/native/
matsim_parser.cpp``, compiled at first use into ``build/tarl_tpu_torch/``
(:func:`~tarl_tpu_torch._build.load_host_library`), with zlib for
``.xml.gz`` input; where the host lacks zlib's header it compiles with
``TARL_NO_ZLIB``, and a ``.gz`` path is then the parser's error.

The reference returns ``None`` on any failure and lets its caller take
the Python parser.  Here a failure raises :class:`NativeError` (the
library cannot be built, or the parser reports an error), and ``None``
means only what the parser asks for: a population whose plans name
coordinates, which the Python parser's nearest-intersection search
reads.  :mod:`~tarl_tpu_torch.io.matsim` decides what a failure means.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np

from .. import _build

SOURCE = _build.PACKAGE_DIR / "native" / "matsim_parser.cpp"
LIBRARY = "tarl_matsim"

_lib: Optional[ctypes.CDLL] = None
_build_error: Optional[str] = None


class NativeError(RuntimeError):
    """The native parser cannot be built, or it failed on a file."""


def _declare(lib: ctypes.CDLL) -> None:
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    vp, cp = ctypes.c_void_p, ctypes.c_char_p
    for name, res, args in (
            ("tarl_has_gzip", ctypes.c_int32, []),
            ("tarl_parse_network", vp, [cp]),
            ("tarl_net_error", cp, [vp]),
            ("tarl_net_num_links", ctypes.c_int64, [vp]),
            ("tarl_net_num_intersections", ctypes.c_int64, [vp]),
            ("tarl_net_cell_size", ctypes.c_double, [vp]),
            ("tarl_net_fill", None, [vp, f64p, f64p, f64p, f64p, i32p,
                                     i32p]),
            ("tarl_net_coords", None, [vp, f64p, f64p]),
            ("tarl_net_ids_size", ctypes.c_int64, [vp]),
            ("tarl_net_ids_fill", None, [vp, cp]),
            ("tarl_net_free", None, [vp]),
            ("tarl_parse_population", vp, [cp, cp]),
            ("tarl_pop_error", cp, [vp]),
            ("tarl_pop_needs_fallback", ctypes.c_int32, [vp]),
            ("tarl_pop_num_rows", ctypes.c_int64, [vp]),
            ("tarl_pop_fill", None, [vp, f32p]),
            ("tarl_pop_stats", None, [vp, i64p]),
            ("tarl_pop_free", None, [vp])):
        fn = getattr(lib, name)
        fn.restype = res
        fn.argtypes = args


def load_library() -> ctypes.CDLL:
    """The parser's library, built where it is missing.  Raises
    :class:`NativeError` with the compiler's stderr where it cannot be
    built (and again on every later call in this process)."""
    global _lib, _build_error
    if _lib is not None:
        return _lib
    if _build_error is not None:
        raise NativeError(_build_error)
    try:
        try:
            lib = _build.load_host_library(LIBRARY, SOURCE, libs=("z",))
        except RuntimeError as e:
            if "zlib.h" not in str(e):
                raise
            lib = _build.load_host_library(LIBRARY, SOURCE,
                                           defines=("TARL_NO_ZLIB",))
    except RuntimeError as e:
        _build_error = f"the native MATSim parser cannot be built: {e}"
        raise NativeError(_build_error) from None
    _declare(lib)
    _lib = lib
    return lib


def available() -> bool:
    """Whether the library builds and loads."""
    try:
        load_library()
    except NativeError:
        return False
    return True


def gzip_supported() -> bool:
    """Whether the library reads ``.xml.gz`` (it was built with zlib)."""
    return bool(load_library().tarl_has_gzip())


def _error(err: bytes, path: str, *read: str) -> NativeError:
    """The parser's error ``err`` on ``path`` (the files it read:
    ``read``)."""
    gz = any(p.endswith(".gz") for p in read)
    hint = (" (built without zlib: no .gz input)"
            if gz and not gzip_supported() else "")
    return NativeError(f"native parser, {path}: {err.decode()}{hint}")


def parse_network_native(actual_path: str) -> dict:
    """Parse a resolved network XML path: the fields of
    :class:`~tarl_tpu_torch.io.matsim.ParsedNetwork` but the link ids, as
    the reference's returns them."""
    lib = load_library()
    h = lib.tarl_parse_network(actual_path.encode())
    try:
        err = lib.tarl_net_error(h)
        if err:
            raise _error(err, actual_path, actual_path)
        n = lib.tarl_net_num_links(h)
        ni = lib.tarl_net_num_intersections(h)
        length, capacity, freespeed, permlanes = (np.empty(n, np.float64)
                                                  for _ in range(4))
        from_idx, to_idx = np.empty(n, np.int32), np.empty(n, np.int32)
        lib.tarl_net_fill(h, length, capacity, freespeed, permlanes,
                          from_idx, to_idx)
        x, y = np.empty(ni, np.float64), np.empty(ni, np.float64)
        lib.tarl_net_coords(h, x, y)
        buf = ctypes.create_string_buffer(int(lib.tarl_net_ids_size(h)))
        lib.tarl_net_ids_fill(h, buf)
        ids = buf.raw.decode().split("\n")[:-1]
        return {
            "length": length,
            "max_flow": capacity,
            "free_speed": freespeed,
            "perm_lanes": permlanes,
            "from_inter": from_idx.astype(np.int64),
            "to_inter": to_idx.astype(np.int64),
            "sorted_intersections": ids,
            "node_positions": {i: (float(a), float(b))
                               for i, a, b in zip(ids, x, y)},
            "effective_cell_size": float(lib.tarl_net_cell_size(h)),
        }
    finally:
        lib.tarl_net_free(h)


def parse_population_native(pop_path: str, net_path: str):
    """Parse resolved population and network paths into the reference's
    float32 ``[A, 9]`` trip rows.  Returns ``(rows, stats)``, or ``None``
    where plans name coordinates (the Python parser's path)."""
    lib = load_library()
    h = lib.tarl_parse_population(pop_path.encode(), net_path.encode())
    try:
        err = lib.tarl_pop_error(h)
        if err:
            raise _error(err, pop_path, pop_path, net_path)
        if lib.tarl_pop_needs_fallback(h):
            return None
        rows = np.empty((int(lib.tarl_pop_num_rows(h)), 9), np.float32)
        lib.tarl_pop_fill(h, rows)
        stats = np.empty(7, np.int64)
        lib.tarl_pop_stats(h, stats)
        return rows, {
            "total_agents": int(stats[0]),
            "selected_agents": int(stats[1]),
            "car_avail_not_always": int(stats[2]),
            "no_plan": int(stats[3]),
            "too_few_activities": int(stats[4]),
            "no_valid_trip": int(stats[5]),
            "invalid_trip_coords": int(stats[6]),
        }
    finally:
        lib.tarl_pop_free(h)

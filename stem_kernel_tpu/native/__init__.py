"""Native C++ runtime components (SMO solver, DAG topology scan).

Built into one shared library with `python -m stem_kernel_tpu.native.build`
(plain g++, no external dependencies) and loaded via ctypes.  Every native
entry point has a NumPy fallback; `available()` reports whether the library
is loaded, and tests assert native/Python agreement when it is.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

_LIB_PATH = os.path.join(os.path.dirname(__file__), "libsktnative.so")
_lib = None


def _load():
    global _lib
    if _lib is None and os.path.exists(_LIB_PATH):
        lib = ctypes.CDLL(_LIB_PATH)
        dptr = np.ctypeslib.ndpointer(dtype=np.float64, flags="C_CONTIGUOUS")
        iptr = np.ctypeslib.ndpointer(dtype=np.int32, flags="C_CONTIGUOUS")
        lib.smo_solve.argtypes = [
            dptr, dptr, dptr, ctypes.c_int, ctypes.c_double, ctypes.c_double,
            ctypes.c_double, ctypes.c_long, dptr,
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_long),
        ]
        lib.smo_solve.restype = ctypes.c_int
        fptr = np.ctypeslib.ndpointer(dtype=np.float32, flags="C_CONTIGUOUS")
        if hasattr(lib, "smo_solve_f32"):
            lib.smo_solve_f32.argtypes = [
                fptr, dptr, dptr, ctypes.c_int, ctypes.c_double,
                ctypes.c_double, ctypes.c_double, ctypes.c_long, dptr,
                ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
                ctypes.POINTER(ctypes.c_long),
            ]
            lib.smo_solve_f32.restype = ctypes.c_int
        if hasattr(lib, "smo_solve_nu_f32"):
            lib.smo_solve_nu_f32.argtypes = [
                fptr, dptr, dptr, ctypes.c_int, ctypes.c_double,
                ctypes.c_double, dptr, ctypes.c_double, ctypes.c_long, dptr,
                ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
                ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_long),
            ]
            lib.smo_solve_nu_f32.restype = ctypes.c_int
        if hasattr(lib, "smo_solve_nu"):  # older cached builds lack it
            lib.smo_solve_nu.argtypes = [
                dptr, dptr, dptr, ctypes.c_int, ctypes.c_double,
                ctypes.c_double, dptr, ctypes.c_double, ctypes.c_long, dptr,
                ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
                ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_long),
            ]
            lib.smo_solve_nu.restype = ctypes.c_int
        lib.dag_build.argtypes = [dptr, ctypes.c_int, ctypes.c_double]
        lib.dag_build.restype = ctypes.c_void_p
        lib.dag_sizes.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int),
                                  ctypes.POINTER(ctypes.c_int)]
        lib.dag_copy.argtypes = [ctypes.c_void_p, iptr, iptr, iptr, iptr, iptr]
        lib.dag_free.argtypes = [ctypes.c_void_p]
        _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def smo_solve_native(K, y, p, C_p, C_n, eps, max_iter):
    """Returns (alpha, rho, obj, n_iter) or None if the library is absent."""
    lib = _load()
    if lib is None:
        return None
    n = len(y)
    y = np.ascontiguousarray(y, dtype=np.float64)
    p = np.ascontiguousarray(p, dtype=np.float64)
    alpha = np.zeros(n, dtype=np.float64)
    rho = ctypes.c_double()
    obj = ctypes.c_double()
    it = ctypes.c_long()
    # float32 Gram matrices (the framework's native dtype) go straight to the
    # f32 instantiation: converting an n x n matrix to float64 cost 50x the
    # solve itself at n = 30k (measured on the host CPU)
    if K.dtype == np.float32 and hasattr(lib, "smo_solve_f32"):
        K = np.ascontiguousarray(K, dtype=np.float32)
        lib.smo_solve_f32(K, y, p, n, C_p, C_n, eps, int(max_iter), alpha,
                          ctypes.byref(rho), ctypes.byref(obj), ctypes.byref(it))
    else:
        K = np.ascontiguousarray(K, dtype=np.float64)
        lib.smo_solve(K, y, p, n, C_p, C_n, eps, int(max_iter), alpha,
                      ctypes.byref(rho), ctypes.byref(obj), ctypes.byref(it))
    return alpha, rho.value, obj.value, it.value


def smo_solve_nu_native(K, y, p, C_p, C_n, alpha0, eps, max_iter):
    """Returns (alpha, rho, r, obj, n_iter) or None if the library is absent."""
    lib = _load()
    if lib is None or not hasattr(lib, "smo_solve_nu"):
        return None
    n = len(y)
    y = np.ascontiguousarray(y, dtype=np.float64)
    p = np.ascontiguousarray(p, dtype=np.float64)
    a0 = np.ascontiguousarray(alpha0, dtype=np.float64)
    alpha = np.zeros(n, dtype=np.float64)
    rho = ctypes.c_double()
    r = ctypes.c_double()
    obj = ctypes.c_double()
    it = ctypes.c_long()
    if K.dtype == np.float32 and hasattr(lib, "smo_solve_nu_f32"):
        K = np.ascontiguousarray(K, dtype=np.float32)
        lib.smo_solve_nu_f32(K, y, p, n, C_p, C_n, a0, eps, int(max_iter),
                             alpha, ctypes.byref(rho), ctypes.byref(r),
                             ctypes.byref(obj), ctypes.byref(it))
    else:
        K = np.ascontiguousarray(K, dtype=np.float64)
        lib.smo_solve_nu(K, y, p, n, C_p, C_n, a0, eps, int(max_iter),
                         alpha, ctypes.byref(rho), ctypes.byref(r),
                         ctypes.byref(obj), ctypes.byref(it))
    return alpha, rho.value, r.value, obj.value, it.value


def dag_scan_native(bpp, th):
    """Returns (first, last, edge_to, edge_gaps, edge_ptr) or None."""
    lib = _load()
    if lib is None:
        return None
    bpp = np.ascontiguousarray(bpp, dtype=np.float64)
    h = lib.dag_build(bpp, bpp.shape[0], th)
    n_nodes = ctypes.c_int()
    n_edges = ctypes.c_int()
    lib.dag_sizes(h, ctypes.byref(n_nodes), ctypes.byref(n_edges))
    first = np.zeros(n_nodes.value, np.int32)
    last = np.zeros(n_nodes.value, np.int32)
    edge_to = np.zeros(max(n_edges.value, 1), np.int32)
    edge_gaps = np.zeros(max(n_edges.value, 1), np.int32)
    edge_ptr = np.zeros(n_nodes.value + 1, np.int32)
    lib.dag_copy(h, first, last, edge_to, edge_gaps, edge_ptr)
    lib.dag_free(h)
    return first, last, edge_to[: n_edges.value], edge_gaps[: n_edges.value], edge_ptr

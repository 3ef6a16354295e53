"""Native (C++) host runtime: batch packing and job scheduling.

Compiled with g++ from ``packer.cpp`` on first use into a library named
by the hash of the source and the compiler flags (not kept in git); all
entry points degrade gracefully to the numpy implementations in
:mod:`graphdot_tpu.graph.batch` when no compiler is available.
"""
import ctypes
import hashlib
import os
import subprocess
import warnings

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, 'packer.cpp')
_FLAGS = ['-O3', '-shared', '-fPIC']

_lib = None
_tried = False


def _library_path():
    with open(_SRC, 'rb') as f:
        key = hashlib.sha256(f.read() + ' '.join(_FLAGS).encode())
    return os.path.join(_DIR, f'_packer-{key.hexdigest()[:16]}.so')


def _build(path):
    """Compile into a private temporary file, then rename it into place:
    concurrent first uses (test workers) never see a partial library."""
    tmp = f'{path}.{os.getpid()}.tmp'
    try:
        subprocess.run(['g++', *_FLAGS, '-o', tmp, _SRC],
                       check=True, capture_output=True)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _load():
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    try:
        path = _library_path()
        if not os.path.exists(path):
            _build(path)
        lib = ctypes.CDLL(path)

        i32p = np.ctypeslib.ndpointer(np.int32, flags='C_CONTIGUOUS')
        i64p = np.ctypeslib.ndpointer(np.int64, flags='C_CONTIGUOUS')
        f32p = np.ctypeslib.ndpointer(np.float32, flags='C_CONTIGUOUS')

        lib.pack_batch_f32.argtypes = [
            ctypes.c_int32, i32p, i64p, i32p, i32p, f32p,
            ctypes.c_int32, ctypes.c_int32,
            f32p, f32p, f32p, i32p, i32p, f32p, i32p
        ]
        lib.pack_batch_f32.restype = None
        lib.pack_edge_feature_f32.argtypes = [
            ctypes.c_int32, i64p, i32p, i32p, f32p,
            ctypes.c_int32, ctypes.c_int32, f32p, f32p
        ]
        lib.pack_edge_feature_f32.restype = None
        lib.schedule_jobs_by_cost.argtypes = [
            ctypes.c_int64, i32p, i32p, i32p, i64p
        ]
        lib.schedule_jobs_by_cost.restype = None
        _lib = lib
    except Exception as e:  # pragma: no cover - depends on toolchain
        warnings.warn(
            f'native packer unavailable ({e}); falling back to numpy'
        )
        _lib = None
    return _lib


def available():
    return _load() is not None


def pack_batch(n_nodes, edge_offsets, ei, ej, ew, n_pad, m_pad):
    """Pack concatenated edge lists into padded batch arrays.

    Returns (adj, degree, node_mask, esrc, edst, ew_out, n_edge) or None
    when the native library is unavailable.
    """
    lib = _load()
    if lib is None:
        return None
    B = len(n_nodes)
    n_nodes = np.ascontiguousarray(n_nodes, dtype=np.int32)
    edge_offsets = np.ascontiguousarray(edge_offsets, dtype=np.int64)
    ei = np.ascontiguousarray(ei, dtype=np.int32)
    ej = np.ascontiguousarray(ej, dtype=np.int32)
    ew = np.ascontiguousarray(ew, dtype=np.float32)
    adj = np.zeros((B, n_pad, n_pad), dtype=np.float32)
    degree = np.zeros((B, n_pad), dtype=np.float32)
    node_mask = np.zeros((B, n_pad), dtype=np.float32)
    esrc = np.zeros((B, m_pad), dtype=np.int32)
    edst = np.zeros((B, m_pad), dtype=np.int32)
    ew_out = np.zeros((B, m_pad), dtype=np.float32)
    n_edge = np.zeros(B, dtype=np.int32)
    lib.pack_batch_f32(
        B, n_nodes, edge_offsets, ei, ej, ew, n_pad, m_pad,
        adj, degree, node_mask, esrc, edst, ew_out, n_edge
    )
    return adj, degree, node_mask, esrc, edst, ew_out, n_edge


def pack_edge_feature(edge_offsets, ei, ej, values, B, n_pad, m_pad):
    """Scatter a scalar edge-feature column; returns (mat, elist) or
    None."""
    lib = _load()
    if lib is None:
        return None
    edge_offsets = np.ascontiguousarray(edge_offsets, dtype=np.int64)
    ei = np.ascontiguousarray(ei, dtype=np.int32)
    ej = np.ascontiguousarray(ej, dtype=np.int32)
    values = np.ascontiguousarray(values, dtype=np.float32)
    mat = np.zeros((B, n_pad, n_pad), dtype=np.float32)
    elist = np.zeros((B, m_pad), dtype=np.float32)
    lib.pack_edge_feature_f32(
        B, edge_offsets, ei, ej, values, n_pad, m_pad, mat, elist
    )
    return mat, elist


def schedule_jobs(i_idx, j_idx, n_nodes):
    """Cost-descending job permutation, or None."""
    lib = _load()
    if lib is None:
        return None
    i_idx = np.ascontiguousarray(i_idx, dtype=np.int32)
    j_idx = np.ascontiguousarray(j_idx, dtype=np.int32)
    n_nodes = np.ascontiguousarray(n_nodes, dtype=np.int32)
    order = np.zeros(len(i_idx), dtype=np.int64)
    lib.schedule_jobs_by_cost(len(i_idx), i_idx, j_idx, n_nodes, order)
    return order

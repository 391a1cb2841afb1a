"""ctypes bindings for the framework-free native library
(``native/rayito_native.cpp``, built with ``make -C native``).

Counterpart of ``rayito_tpu/utils/native.py`` with the same rule: when the
library is present the BVH order and the OBJ parse run in C++, otherwise
the Python builders run. The library is looked up in the repo's ``native/``
directory and via ``RAYITO_NATIVE_LIB``.
"""

from __future__ import annotations

import ctypes
import functools
import os
from typing import Optional

import numpy as np

_F32P = ctypes.POINTER(ctypes.c_float)
_I32P = ctypes.POINTER(ctypes.c_int32)


def _find_lib() -> Optional[str]:
    env = os.environ.get("RAYITO_NATIVE_LIB")
    if env and os.path.exists(env):
        return env
    here = os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    )
    cand = os.path.join(here, "native", "librayito_native.so")
    return cand if os.path.exists(cand) else None


@functools.lru_cache(maxsize=None)
def _load() -> Optional[ctypes.CDLL]:
    path = _find_lib()
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(path)
    except OSError:
        return None
    lib.rayito_bvh_order.restype = ctypes.c_int
    lib.rayito_bvh_order.argtypes = [_F32P, _F32P, _F32P, ctypes.c_int32,
                                     _I32P]
    lib.rayito_obj_parse.restype = ctypes.c_void_p
    lib.rayito_obj_parse.argtypes = [ctypes.c_char_p]
    for name in ("rayito_obj_num_vertices", "rayito_obj_num_normals",
                 "rayito_obj_num_tris"):
        getattr(lib, name).restype = ctypes.c_int32
        getattr(lib, name).argtypes = [ctypes.c_void_p]
    lib.rayito_obj_copy.restype = None
    lib.rayito_obj_copy.argtypes = [ctypes.c_void_p, _F32P, _F32P, _I32P,
                                    _I32P, _I32P]
    lib.rayito_obj_free.restype = None
    lib.rayito_obj_free.argtypes = [ctypes.c_void_p]
    return lib


def is_available() -> bool:
    return _load() is not None


def bvh_order(v0, v1, v2) -> Optional[np.ndarray]:
    """Native DFS primitive order; None when the library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    v0, v1, v2 = (np.ascontiguousarray(v, np.float32) for v in (v0, v1, v2))
    out = np.empty(v0.shape[0], np.int32)
    depth = lib.rayito_bvh_order(
        v0.ctypes.data_as(_F32P), v1.ctypes.data_as(_F32P),
        v2.ctypes.data_as(_F32P), np.int32(v0.shape[0]),
        out.ctypes.data_as(_I32P),
    )
    return None if depth < 0 else out


def parse_obj(path: str):
    """Native OBJ parse. Returns (vertices [V,3], normals [Vn,3] | None,
    tri_idx [T,3], tri_nidx [T,3], face_ids [T]) or None."""
    lib = _load()
    if lib is None:
        return None
    h = lib.rayito_obj_parse(path.encode())
    if not h:
        return None
    try:
        nv = lib.rayito_obj_num_vertices(h)
        nn = lib.rayito_obj_num_normals(h)
        nt = lib.rayito_obj_num_tris(h)
        vertices = np.empty((nv, 3), np.float32)
        normals = np.empty((max(nn, 1), 3), np.float32)
        tri_idx = np.empty((nt, 3), np.int32)
        tri_nidx = np.empty((nt, 3), np.int32)
        face_ids = np.empty(nt, np.int32)
        lib.rayito_obj_copy(
            h, vertices.ctypes.data_as(_F32P), normals.ctypes.data_as(_F32P),
            tri_idx.ctypes.data_as(_I32P), tri_nidx.ctypes.data_as(_I32P),
            face_ids.ctypes.data_as(_I32P),
        )
    finally:
        lib.rayito_obj_free(h)
    return vertices, (normals if nn else None), tri_idx, tri_nidx, face_ids

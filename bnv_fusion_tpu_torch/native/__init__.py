"""Native (C++) host code, loaded via ctypes.

``mesh_ops.cpp`` is the host mesher, a copy of the JAX package's source
(bnv_fusion_tpu/native/__init__.py:22-179); ``image_ops.cpp`` is the image
codec behind ``utils.image_io`` (the JAX package uses cv2).  Each is built
with the system ``c++`` into ``bnv_fusion_tpu_torch/_build/lib<name>.so`` at
first use.  A failed build raises; mesh callers that want the numpy path
pass ``use_native=False``, the codec has none.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Dict

import numpy as np

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
_HERE = os.path.dirname(os.path.abspath(__file__))
_BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")


def load_library(name: str) -> ctypes.CDLL:
    """``lib<name>.so`` built from ``<name>.cpp`` (rebuilt when the source
    is newer), loaded once per process."""
    with _LOCK:
        if name in _LIBS:
            return _LIBS[name]
        src = os.path.join(_HERE, f"{name}.cpp")
        lib_path = os.path.join(_BUILD_DIR, f"lib{name}.so")
        if (not os.path.exists(lib_path) or
                os.path.getmtime(lib_path) < os.path.getmtime(src)):
            os.makedirs(_BUILD_DIR, exist_ok=True)
            tmp = f"{lib_path}.{os.getpid()}.tmp"
            res = subprocess.run(["c++", "-O3", "-shared", "-fPIC",
                                  "-std=c++17", src, "-o", tmp],
                                 capture_output=True, text=True)
            if res.returncode != 0:
                raise RuntimeError(f"building {name}.cpp failed:\n"
                                   f"{res.stdout}{res.stderr}")
            os.replace(tmp, lib_path)
        lib = ctypes.CDLL(lib_path)
        _LIBS[name] = lib
        return lib


def _build_and_load() -> ctypes.CDLL:
    lib = load_library("mesh_ops")
    i64p = ctypes.POINTER(ctypes.c_int64)
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.mesh_ops_marching_tets.restype = ctypes.c_int64
    lib.mesh_ops_marching_tets.argtypes = [i64p, f32p, ctypes.c_int64,
                                           ctypes.c_double]
    lib.mesh_ops_marching_tets_indexed.restype = ctypes.c_int64
    lib.mesh_ops_marching_tets_indexed.argtypes = [
        i64p, i64p, f32p, ctypes.c_int64, ctypes.c_int, ctypes.c_float,
        ctypes.c_double]
    lib.mesh_ops_num_vertices.restype = ctypes.c_int64
    lib.mesh_ops_get.argtypes = [f32p, ctypes.POINTER(ctypes.c_int32)]
    lib.mesh_ops_get_face_cells.argtypes = [i64p]
    lib.mesh_ops_build_lattice.restype = ctypes.c_int64
    lib.mesh_ops_build_lattice.argtypes = [i64p, ctypes.c_int64,
                                           ctypes.c_int]
    lib.mesh_ops_lattice_num_points.restype = ctypes.c_int64
    lib.mesh_ops_lattice_get.argtypes = [i64p, i64p, i64p]
    return lib


def available() -> bool:
    """True when the host mesher builds and loads (the JAX package's
    ``native.available``; a failed build is reported as False here, where
    the mesh callers raise it)."""
    try:
        _build_and_load()
    except (OSError, RuntimeError):
        return False
    return True


def marching_tetrahedra_native(cell_origins: np.ndarray, cell_sdf: np.ndarray,
                               weld_tol: float = 0.0):
    """Marching tetrahedra over sparse cells with the optional in-pass weld
    (counterpart of bnv_fusion_tpu/native/__init__.py:73-98): origins
    [M, 3], corner SDF [M, 8] in (4dx + 2dy + dz) order.  Returns (vertices
    [V, 3] float32 in lattice units, faces [F, 3] int32)."""
    lib = _build_and_load()
    origins = np.ascontiguousarray(cell_origins, np.int64)
    sdf = np.ascontiguousarray(cell_sdf, np.float32)
    with _LOCK:
        n_faces = lib.mesh_ops_marching_tets(
            origins.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            sdf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            len(origins), float(weld_tol))
        n_verts = lib.mesh_ops_num_vertices()
        verts = np.empty((n_verts, 3), np.float32)
        faces = np.empty((n_faces, 3), np.int32)
        if n_verts:
            lib.mesh_ops_get(
                verts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                faces.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        lib.mesh_ops_free()
    return verts, faces


def marching_tetrahedra_indexed_native(cells: np.ndarray,
                                       corner_idx: np.ndarray,
                                       sdf: np.ndarray, use_sentinel: bool,
                                       nan_fallback: float,
                                       weld_tol: float = 0.0,
                                       return_cell_ids: bool = False):
    """Fused corner gather + observed-crossing gate + marching tetrahedra
    + weld over all lattice cells.  With ``use_sentinel`` a cell meshes only
    when its non-NaN corners cross the level set; NaN corners interpolate as
    ``nan_fallback``.  Returns (vertices [V,3] float32 lattice units, faces
    [F,3] int32); with ``return_cell_ids`` also each face's source index
    into ``cells`` ([F] int64; the incremental mesher keys its triangle
    cache by cell)."""
    lib = _build_and_load()
    cells = np.ascontiguousarray(cells, np.int64)
    corner_idx = np.ascontiguousarray(corner_idx, np.int64)
    sdf = np.ascontiguousarray(sdf, np.float32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    with _LOCK:
        n_faces = lib.mesh_ops_marching_tets_indexed(
            cells.ctypes.data_as(i64p), corner_idx.ctypes.data_as(i64p),
            sdf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            len(cells), int(bool(use_sentinel)), float(nan_fallback),
            float(weld_tol))
        n_verts = lib.mesh_ops_num_vertices()
        verts = np.empty((n_verts, 3), np.float32)
        faces = np.empty((n_faces, 3), np.int32)
        face_cells = np.empty((n_faces,), np.int64)
        if n_verts:
            lib.mesh_ops_get(
                verts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                faces.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
            if return_cell_ids:
                lib.mesh_ops_get_face_cells(face_cells.ctypes.data_as(i64p))
        lib.mesh_ops_free()
    if return_cell_ids:
        return verts, faces, face_cells
    return verts, faces


def build_sample_lattice_native(active_coords: np.ndarray, scale: int = 2):
    """C++ twin of mesh.build_sample_lattice (bit-identical output order):
    (points [P,3] int64, corner_idx [M,8] int64, cells [M,3] int64)."""
    lib = _build_and_load()
    coords = np.ascontiguousarray(active_coords, np.int64)
    i64p = ctypes.POINTER(ctypes.c_int64)
    with _LOCK:
        m = lib.mesh_ops_build_lattice(coords.ctypes.data_as(i64p),
                                       len(coords), int(scale))
        p = lib.mesh_ops_lattice_num_points()
        points = np.empty((p, 3), np.int64)
        corner_idx = np.empty((m, 8), np.int64)
        cells = np.empty((m, 3), np.int64)
        if p:
            lib.mesh_ops_lattice_get(points.ctypes.data_as(i64p),
                                     corner_idx.ctypes.data_as(i64p),
                                     cells.ctypes.data_as(i64p))
        lib.mesh_ops_lattice_free()
    return points, corner_idx, cells

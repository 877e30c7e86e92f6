"""ctypes bindings for the native C++ runtime layer.

The reference's runtime is native C++ (builder: index_builder/build.cpp,
engine: hnswlib/hnswalg.h, store: storage_service/rocksdb_store.cpp); ours is
too. pybind11 is not available in this image, so the boundary is a C ABI
loaded via ctypes. The shared object is compiled on first use with g++ -O3
-march=native and cached next to the sources.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}


def _build_and_load(name: str) -> ctypes.CDLL:
    """Compile native/<name>.cpp to <name>.so (if stale) and dlopen it."""
    src = os.path.join(_HERE, f"{name}.cpp")
    # "lib" prefix so the .so can't shadow a same-named .py module on import
    so = os.path.join(_HERE, f"lib{name}.so")
    with _LOCK:
        if name in _LIBS:
            return _LIBS[name]
        need = not os.path.exists(so) or os.path.getmtime(so) < os.path.getmtime(src)
        if need:
            tmp = so + f".tmp.{os.getpid()}"
            cmd = [
                "g++", "-O3", "-march=native", "-std=c++20", "-shared", "-fPIC",
                "-o", tmp, src,
            ]
            subprocess.run(cmd, check=True, capture_output=True, text=True)
            os.replace(tmp, so)
        lib = ctypes.CDLL(so)
        _LIBS[name] = lib
        return lib


def build_binary(name: str) -> str:
    """Compile native/<name>.cpp to an executable (if stale) and return its
    path. Used for the native service frontends (storage_main, query_main)."""
    src = os.path.join(_HERE, f"{name}.cpp")
    exe = os.path.join(_HERE, f"bin_{name}")
    deps = [src, os.path.join(_HERE, "httpkit.h"),
            os.path.join(_HERE, "vecstore.cpp")]
    newest = max(os.path.getmtime(p) for p in deps if os.path.exists(p))
    with _LOCK:
        if not os.path.exists(exe) or os.path.getmtime(exe) < newest:
            tmp = exe + f".tmp.{os.getpid()}"
            cmd = [
                "g++", "-O3", "-march=native", "-std=c++20", "-pthread",
                "-o", tmp, src,
            ]
            subprocess.run(cmd, check=True, capture_output=True, text=True)
            os.replace(tmp, exe)
    return exe


def load_vecstore_lib() -> ctypes.CDLL:
    lib = _build_and_load("vecstore")
    c = ctypes
    P = c.POINTER
    lib.vs_open.restype = c.c_void_p
    lib.vs_open.argtypes = [c.c_char_p]
    lib.vs_close.argtypes = [c.c_void_p]
    lib.vs_put.restype = c.c_int
    lib.vs_put.argtypes = [c.c_void_p, c.c_uint32, c.c_uint32, P(c.c_float)]
    lib.vs_flush.restype = c.c_int
    lib.vs_flush.argtypes = [c.c_void_p]
    lib.vs_get.restype = c.c_int64
    lib.vs_get.argtypes = [c.c_void_p, c.c_uint32, P(c.c_float), c.c_int64]
    lib.vs_batch_get.restype = c.c_int
    lib.vs_batch_get.argtypes = [
        c.c_void_p, P(c.c_uint32), c.c_int64, c.c_uint32, P(c.c_float), P(c.c_uint8),
    ]
    lib.vs_count.restype = c.c_int64
    lib.vs_count.argtypes = [c.c_void_p]
    lib.vs_ids.argtypes = [c.c_void_p, P(c.c_uint32)]
    return lib


def load_builder_lib() -> ctypes.CDLL:
    lib = _build_and_load("builder")
    c = ctypes
    P = c.POINTER
    lib.hnsw_create.restype = c.c_void_p
    lib.hnsw_create.argtypes = [c.c_int, c.c_int, c.c_int, c.c_int, c.c_uint64]
    lib.hnsw_free.argtypes = [c.c_void_p]
    lib.hnsw_add.argtypes = [c.c_void_p, P(c.c_float), c.c_int64]
    lib.hnsw_add_batch.argtypes = [
        c.c_void_p, P(c.c_float), P(c.c_int64), c.c_int64, c.c_int,
    ]
    lib.hnsw_add_with_level.argtypes = [c.c_void_p, P(c.c_float), c.c_int64, c.c_int]
    lib.hnsw_register_level0_batch.restype = c.c_int64
    lib.hnsw_register_level0_batch.argtypes = [
        c.c_void_p, P(c.c_float), P(c.c_int64), c.c_int64,
    ]
    lib.hnsw_connect_batch.argtypes = [
        c.c_void_p, P(c.c_uint32), c.c_int64, P(c.c_int32), c.c_int,
    ]
    lib.hnsw_mark_deleted.argtypes = [c.c_void_p, c.c_int64]
    lib.hnsw_mark_deleted.restype = c.c_int
    lib.hnsw_unmark_deleted.argtypes = [c.c_void_p, c.c_int64]
    lib.hnsw_unmark_deleted.restype = c.c_int
    for fn, res in [
        ("hnsw_size", c.c_int64),
        ("hnsw_max_level", c.c_int),
        ("hnsw_entry_point", c.c_int),
        ("hnsw_dim", c.c_int),
        ("hnsw_m", c.c_int),
        ("hnsw_max_m0", c.c_int),
        ("hnsw_num_deleted", c.c_int64),
        ("hnsw_capacity", c.c_int64),
        ("hnsw_index_file_size", c.c_int64),
    ]:
        getattr(lib, fn).argtypes = [c.c_void_p]
        getattr(lib, fn).restype = res
    lib.hnsw_clear.argtypes = [c.c_void_p]
    lib.hnsw_get_data_by_label.argtypes = [c.c_void_p, c.c_int64, P(c.c_float)]
    lib.hnsw_get_data_by_label.restype = c.c_int
    lib.hnsw_export_level0.argtypes = [c.c_void_p, P(c.c_int32)]
    lib.hnsw_export_levels.argtypes = [c.c_void_p, P(c.c_int32)]
    lib.hnsw_export_labels.argtypes = [c.c_void_p, P(c.c_int64)]
    lib.hnsw_export_deleted.argtypes = [c.c_void_p, P(c.c_uint8)]
    lib.hnsw_export_vectors.argtypes = [c.c_void_p, P(c.c_float)]
    lib.hnsw_upper_count.argtypes = [c.c_void_p, c.c_int]
    lib.hnsw_upper_count.restype = c.c_int64
    lib.hnsw_export_upper.argtypes = [c.c_void_p, c.c_int, P(c.c_int32), P(c.c_int32)]
    lib.hnsw_import.restype = c.c_void_p
    lib.hnsw_import.argtypes = [
        c.c_int, c.c_int, c.c_int, c.c_int, c.c_uint64, c.c_int64,
        P(c.c_float), P(c.c_int64), P(c.c_int32), P(c.c_uint8),
        P(c.c_int32), P(c.c_int32), c.c_int, c.c_int,
    ]
    lib.hnsw_search.argtypes = [
        c.c_void_p, P(c.c_float), c.c_int, c.c_int, P(c.c_int64), P(c.c_float),
    ]
    lib.hnsw_search.restype = c.c_int
    lib.hnsw_search_batch.argtypes = [
        c.c_void_p, P(c.c_float), c.c_int64, c.c_int, c.c_int,
        P(c.c_int64), P(c.c_float), P(c.c_int32),
    ]
    lib.hnsw_add_replace.argtypes = [c.c_void_p, P(c.c_float), c.c_int64]
    lib.hnsw_add_replace.restype = c.c_int
    lib.hnsw_dirty_count.argtypes = [c.c_void_p]
    lib.hnsw_dirty_count.restype = c.c_int64
    lib.hnsw_dirty_flags.argtypes = [c.c_void_p]
    lib.hnsw_dirty_flags.restype = c.c_int
    lib.hnsw_take_dirty.argtypes = [c.c_void_p, P(c.c_int32)]
    lib.hnsw_clear_dirty.argtypes = [c.c_void_p]
    lib.hnsw_repair_orphans.argtypes = [c.c_void_p]
    lib.hnsw_export_level0_rows.argtypes = [
        c.c_void_p, P(c.c_int32), c.c_int64, P(c.c_int32)
    ]
    lib.hnsw_export_vectors_range.argtypes = [
        c.c_void_p, c.c_int64, c.c_int64, P(c.c_float)
    ]
    lib.hnsw_export_labels_range.argtypes = [
        c.c_void_p, c.c_int64, c.c_int64, P(c.c_int64)
    ]
    lib.hnsw_export_adj.argtypes = [c.c_void_p, c.c_char_p]
    lib.hnsw_export_adj.restype = c.c_int
    lib.hnsw_flush_updates.argtypes = [c.c_void_p]
    lib.hnsw_flush_updates.restype = c.c_int64
    lib.hnsw_take_vec_dirty.argtypes = [c.c_void_p, P(c.c_int32)]
    lib.hnsw_export_vectors_rows.argtypes = [
        c.c_void_p, P(c.c_int32), c.c_int64, P(c.c_float)
    ]
    lib.hnsw_search_filtered.argtypes = [
        c.c_void_p, P(c.c_float), c.c_int, c.c_int, P(c.c_uint8),
        P(c.c_int64), P(c.c_float),
    ]
    lib.hnsw_search_filtered.restype = c.c_int
    lib.hnsw_search_batch_filtered.argtypes = [
        c.c_void_p, P(c.c_float), c.c_int64, c.c_int, c.c_int, P(c.c_uint8),
        P(c.c_int64), P(c.c_float), P(c.c_int32),
    ]
    return lib

"""ctypes bindings for the native host engine (native/zstdtpu_core.cpp).

Builds the shared library from the tracked sources on first use (g++) into
``native/build/<key>/``, where the key hashes the source, the compiler
flags and this host's CPU (the build targets ``-march=native``), so a
binary built on another host or from other sources is never loaded.
Every binding has a pure-Python fallback in the reference modules;
`AVAILABLE` gates usage so the framework works without a toolchain.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np

_REPO = Path(__file__).resolve().parent.parent
_SRC = _REPO / "native" / "zstdtpu_core.cpp"
_EXT_SRC = _REPO / "native" / "ztpy.cpp"
BUILD_DIR = _REPO / "native" / "build"
# -O2 globally (the branchy matchers measure ~13% faster than at -O3); the
# decode hot loops pin O3 via function attributes.
_CORE_FLAGS = ("-O2", "-march=native", "-shared", "-fPIC", "-std=c++17")
_EXT_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")


def _host_cpu() -> str:
    """This host's CPU model and feature flags (part of the build key)."""
    keep = ("model name", "flags", "Features", "CPU implementer", "CPU part")
    fields: dict = {}
    try:
        for line in Path("/proc/cpuinfo").read_text().splitlines():
            k, _, v = line.partition(":")
            k = k.strip()
            if k in keep and k not in fields:
                fields[k] = v.strip()
    except OSError:
        pass
    return repr((platform.machine(), sorted(fields.items())))


def build_key(sources, flags) -> str:
    """Key of a build: its source texts, its flags and this host's CPU."""
    h = hashlib.sha256()
    for src in sources:
        h.update(hashlib.sha256(src).digest())
    h.update(repr(tuple(flags)).encode())
    h.update(_host_cpu().encode())
    return h.hexdigest()[:20]


def lib_path() -> Path:
    """Where the core library for the current sources and host lives."""
    return (BUILD_DIR / build_key([_SRC.read_bytes()], _CORE_FLAGS)
            / "libzstdtpu_core.so")


def _ext_path(core: Path) -> Path:
    import sysconfig

    flags = _EXT_FLAGS + (sysconfig.get_paths()["include"], sys.version,
                          core.parent.name)
    return (BUILD_DIR / build_key([_EXT_SRC.read_bytes()], flags)
            / "_ztpy.so")


def _compile(out: Path, cmd_for, what: str, timeout: int) -> bool:
    """Build `out` once across processes: under a lock in its directory,
    into a temporary name renamed into place when the compiler succeeds."""
    import fcntl

    out.parent.mkdir(parents=True, exist_ok=True)
    with open(out.parent / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():
            return True
        tmp = out.with_name(out.name + ".tmp")
        try:
            r = subprocess.run(cmd_for(tmp), capture_output=True, text=True,
                               timeout=timeout)
        except (OSError, subprocess.TimeoutExpired) as e:  # pragma: no cover
            print(f"{what} build error: {e}", file=sys.stderr)
            return False
        if r.returncode != 0:
            print(f"{what} build failed:\n{r.stderr}", file=sys.stderr)
            return False
        os.replace(tmp, out)
        return True


class DPlaneCtx(ctypes.Structure):
    """Mirror of ZtDPlaneCtx (native/zstdtpu_core.cpp): the device-plane
    planner's caller-owned operand buffers + counters."""

    _fields_ = (
        [(n, ctypes.c_int64) for n in
         ("pool_cap", "pool_off", "huf_cap", "n_huf", "fse_cap", "n_fse",
          "huf_maxw", "fse_maxw", "s_cap", "huf_wmax", "fse_wmax",
          "max_seq", "max_out")]
        + [("raw_pool", ctypes.POINTER(ctypes.c_uint8)),
           ("huf_words", ctypes.POINTER(ctypes.c_uint32))]
        + [(n, ctypes.POINTER(ctypes.c_int32)) for n in
           ("huf_limits", "huf_bases", "huf_offs", "huf_shifts",
            "huf_planes", "huf_pos", "huf_nsym", "huf_wlen")]
        + [("fse_words", ctypes.POINTER(ctypes.c_uint32))]
        + [(n, ctypes.POINTER(ctypes.c_int32)) for n in
           ("fse_ll", "fse_of", "fse_ml", "fse_logs", "fse_pos",
            "fse_rep", "fse_nseq", "fse_wlen", "fse_st")]
    )


_lock = threading.Lock()
_lib = None
_ext = None          # CPython extension module (zero-copy entry points)
_ext_tried = False
AVAILABLE = False


def _build(out: Path) -> bool:
    return _compile(out, lambda tmp: ["g++", *_CORE_FLAGS, str(_SRC), "-o",
                                      str(tmp)], "zstdtpu_core", 240)


def _build_ext(out: Path, core: Path) -> bool:
    """CPython extension (zero-copy PyBytes entry points); optional —
    everything it offers has a ctypes fallback."""
    import sysconfig

    return _compile(out, lambda tmp: [
        "g++", *_EXT_FLAGS, f"-I{sysconfig.get_paths()['include']}",
        str(_EXT_SRC), "-o", str(tmp), f"-L{core.parent}", "-lzstdtpu_core",
        f"-Wl,-rpath,{core.parent}"], "_ztpy", 120)


def get_ext():
    """The _ztpy extension module, or None (ctypes paths still work)."""
    global _ext, _ext_tried
    if _ext is not None or _ext_tried:
        return _ext
    with _lock:
        if _ext is not None or _ext_tried:
            return _ext
        _ext_tried = True
        if os.environ.get("ZSTDTPU_NO_NATIVE") or os.environ.get(
                "ZSTDTPU_NO_EXT"):
            return None
    if get_lib() is None:   # builds the core library for these sources
        return None
    with _lock:
        core = lib_path()
        ext = _ext_path(core)
        if not ext.exists() and not _build_ext(ext, core):
            return None
        try:
            import importlib.util

            spec = importlib.util.spec_from_file_location("_ztpy", ext)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            _ext = mod
        except Exception as e:  # pragma: no cover
            print(f"_ztpy load error: {e}", file=sys.stderr)
            return None
    return _ext


def _load():
    global _lib, AVAILABLE
    with _lock:
        if _lib is not None:
            return _lib
        if os.environ.get("ZSTDTPU_NO_NATIVE"):
            return None
        path = lib_path()
        if not path.exists() and not _build(path):
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError:  # pragma: no cover
            return None

        u8p = ctypes.POINTER(ctypes.c_uint8)
        u16p = ctypes.POINTER(ctypes.c_uint16)
        u32p = ctypes.POINTER(ctypes.c_uint32)
        i32p = ctypes.POINTER(ctypes.c_int32)
        i64p = ctypes.POINTER(ctypes.c_int64)
        i64 = ctypes.c_int64
        i32 = ctypes.c_int32

        lib.huf_decode_stream.restype = i64
        lib.huf_decode_stream.argtypes = [u8p, i64, u8p, u8p, i32, u8p, i64]
        lib.fse_decode_sequences.restype = i64
        lib.fse_decode_sequences.argtypes = (
            [u8p, i64, i64]
            + [u32p, u8p, u16p, u8p, i32] * 3
            + [u32p, u32p, u32p, u32p])
        lib.execute_sequences.restype = i64
        lib.execute_sequences.argtypes = [u8p, i64, i64, i64, u8p, i64,
                                          u32p, u32p, u32p, i64]
        lib.fast_find_matches.restype = i64
        lib.fast_find_matches.argtypes = [u8p, i64, i64, i64, i64, i64, i64p,
                                          i32, i32, u32p, u32p, u32p, u32p,
                                          i64, i64p, i32]
        lib.hybrid_select.restype = i64
        lib.hybrid_select.argtypes = [u8p, i64, i32p, u32p, u32p, u32p, u32p,
                                      i64, i64p]
        lib.zt_dp_frame_body.restype = i64
        lib.zt_dp_frame_body.argtypes = [u8p, i64, i32p, i64, u8p, i64]
        lib.lazy_find_matches.restype = i64
        lib.lazy_find_matches.argtypes = [u8p, i64, i64, i64, i64, i64, i64p,
                                          i32, i64p, i64, i64, i32, i64p, u32p,
                                          u32p, u32p, u32p, i64, i64p, i32]
        lib.encode_sequences.restype = i64
        lib.encode_sequences.argtypes = (
            [u32p, u32p, u32p, u8p, u8p, u8p, u8p, u8p, i64]
            + [u16p, u32p, i32p, i32] * 3
            + [u8p, i64])
        lib.huf_encode_stream.restype = i64
        lib.huf_encode_stream.argtypes = [u8p, i64, u16p, u8p, u8p, i64]
        lib.xxh64.restype = ctypes.c_uint64
        lib.xxh64.argtypes = [u8p, i64, ctypes.c_uint64]
        lib.compress_frame_body_c.restype = i64
        lib.compress_frame_body_c.argtypes = [u8p, i64, i32, i32, i32, i32,
                                              i32, i32, u8p, i64]
        lib.compress_frame_body_ldm_c.restype = i64
        lib.compress_frame_body_ldm_c.argtypes = [u8p, i64, i32, i32, i32, i32,
                                                  i32, i32, i32, i32, i32, i32,
                                                  u8p, i64]
        lib.decode_frame_body_c.restype = i64
        lib.decode_frame_body_c.argtypes = [u8p, i64, u8p, i64, i64p]
        vp = ctypes.c_void_p
        lib.zt_cdict_create.restype = vp
        lib.zt_cdict_create.argtypes = [u8p, i64, i32, i32, i32, i32, i32, i32]
        lib.zt_cdict_stats.restype = i64
        lib.zt_cdict_stats.argtypes = [vp, u8p, i64p, i64, i64p, i64p, i64p,
                                       i64p, i64p]
        lib.zt_cdict_free.restype = None
        lib.zt_cdict_free.argtypes = [vp]
        lib.zt_compress_frame_body_cdict.restype = i64
        lib.zt_compress_frame_body_cdict.argtypes = [vp, u8p, i64, u8p, i64]
        lib.zt_ddict_create.restype = vp
        lib.zt_ddict_create.argtypes = [u8p, i64]
        lib.zt_ddict_free.restype = None
        lib.zt_ddict_free.argtypes = [vp]
        lib.zt_decode_frame_body_ddict.restype = i64
        lib.zt_decode_frame_body_ddict.argtypes = [u8p, i64, vp, u8p, i64, i64p]
        lib.zt_compress_many_cdict.restype = i64
        lib.zt_compress_many_cdict.argtypes = [vp, u8p, i64p, i64,
                                               ctypes.c_uint32, u8p, i64, i64p]
        lib.zt_decompress_many_ddict.restype = i64
        lib.zt_decompress_many_ddict.argtypes = [vp, u8p, i64p, i64,
                                                 ctypes.c_uint32, u8p, i64,
                                                 i64p]
        lib.zt_estream_new.restype = vp
        lib.zt_estream_new.argtypes = [i32, i32, i32, i32, i32, i32, i32]
        lib.zt_estream_new2.restype = vp
        lib.zt_estream_new2.argtypes = [i32, i32, i32, i32, i32, i32, i32,
                                        i64, i32]
        lib.zt_estream_preload.restype = i64
        lib.zt_estream_preload.argtypes = [vp, u8p, i64]
        lib.zt_estream_feed.restype = i64
        lib.zt_estream_feed.argtypes = [vp, u8p, i64, i32, u8p, i64]
        lib.zt_estream_free.restype = None
        lib.zt_estream_free.argtypes = [vp]
        lib.zt_estream_pending.restype = i64
        lib.zt_estream_pending.argtypes = [vp]
        lib.zt_estream_bufcap.restype = i64
        lib.zt_estream_bufcap.argtypes = [vp]
        lib.zt_dstream_new.restype = vp
        lib.zt_dstream_new.argtypes = []
        lib.zt_dstream_block.restype = i64
        lib.zt_dstream_block.argtypes = [vp, u8p, i64, u8p, i64, i64, i64]
        lib.zt_dstream_free.restype = None
        lib.zt_dstream_free.argtypes = [vp]
        lib.zt_dstream_drain.restype = i64
        lib.zt_dstream_drain.argtypes = [vp, u8p, i64, u8p, i64, i64, i64,
                                         i64p, ctypes.POINTER(ctypes.c_int)]
        lib.zt_compress_exact.restype = i64
        lib.zt_compress_exact.argtypes = [u8p, i64, i32, i32, u8p, i64]
        ctxp = ctypes.POINTER(DPlaneCtx)
        lib.zt_dplane_frame.restype = ctypes.c_int
        lib.zt_dplane_frame.argtypes = [ctxp, u8p, i64, i32p]
        lib.zt_dplane_batch.restype = i64
        lib.zt_dplane_batch.argtypes = [ctxp, u8p, i64p, i64, i32p, i32p]
        lib.zt_dplane_pack_huf.restype = i64
        lib.zt_dplane_pack_huf.argtypes = [ctxp, u8p, i64, u8p, i64, i64, i64]
        lib.zt_dplane_pack_fse.restype = i64
        lib.zt_dplane_pack_fse.argtypes = [ctxp, u8p, i64, i32p, i32p, i32p,
                                           i64, i64, i64, i32p, i64]

        _lib = lib
        AVAILABLE = True
        return lib


def get_lib():
    return _load()


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _pad_payload(payload: bytes) -> np.ndarray:
    buf = np.zeros(16 + len(payload), dtype=np.uint8)
    buf[16:] = np.frombuffer(payload, dtype=np.uint8)
    return buf


# ---------------------------------------------------------------------------
# High-level wrappers (numpy in/out, mirroring the Python reference API)
# ---------------------------------------------------------------------------


def huf_decode_stream(payload: bytes, sym: np.ndarray, nb: np.ndarray,
                      table_log: int, n_out: int) -> np.ndarray | None:
    lib = get_lib()
    if lib is None:
        return None
    padded = _pad_payload(payload)
    out = np.empty(n_out, dtype=np.uint8)
    rc = lib.huf_decode_stream(_ptr(padded, ctypes.c_uint8), len(payload),
                               _ptr(sym, ctypes.c_uint8), _ptr(nb, ctypes.c_uint8),
                               table_log, _ptr(out, ctypes.c_uint8), n_out)
    if rc != 0:
        return None
    return out


def fse_decode_sequences(payload: bytes, nb_seq: int, ll, of, ml,
                         rep: list[int]):
    """ll/of/ml: FseDTable with base_value/nb_add_bits/new_state/nb_bits."""
    lib = get_lib()
    if lib is None:
        return None
    padded = _pad_payload(payload)
    out_ll = np.empty(nb_seq, dtype=np.uint32)
    out_ml = np.empty(nb_seq, dtype=np.uint32)
    out_of = np.empty(nb_seq, dtype=np.uint32)
    rep_arr = np.array(rep, dtype=np.uint32)

    def tbl(t):
        return (_ptr(np.ascontiguousarray(t.base_value, np.uint32), ctypes.c_uint32),
                _ptr(np.ascontiguousarray(t.nb_add_bits, np.uint8), ctypes.c_uint8),
                _ptr(np.ascontiguousarray(t.new_state, np.uint16), ctypes.c_uint16),
                _ptr(np.ascontiguousarray(t.nb_bits, np.uint8), ctypes.c_uint8),
                t.table_log)

    rc = lib.fse_decode_sequences(
        _ptr(padded, ctypes.c_uint8), len(payload), nb_seq,
        *tbl(ll), *tbl(of), *tbl(ml),
        _ptr(rep_arr, ctypes.c_uint32),
        _ptr(out_ll, ctypes.c_uint32), _ptr(out_ml, ctypes.c_uint32),
        _ptr(out_of, ctypes.c_uint32))
    if rc != 0:
        return None
    rep[0], rep[1], rep[2] = (int(rep_arr[0]), int(rep_arr[1]), int(rep_arr[2]))
    return out_ll, out_ml, out_of


def execute_sequences(out: np.ndarray, out_pos: int, prefix_start: int,
                      literals: np.ndarray, lls, mls, ofs) -> int | None:
    lib = get_lib()
    if lib is None:
        return None
    lit_src = np.ascontiguousarray(literals, np.uint8)
    literals = np.zeros(len(lit_src) + 16, dtype=np.uint8)  # wildcopy slack
    literals[: len(lit_src)] = lit_src
    rc = lib.execute_sequences(
        _ptr(out, ctypes.c_uint8), out_pos, len(out), prefix_start,
        _ptr(literals, ctypes.c_uint8), len(lit_src),
        _ptr(np.ascontiguousarray(lls, np.uint32), ctypes.c_uint32),
        _ptr(np.ascontiguousarray(mls, np.uint32), ctypes.c_uint32),
        _ptr(np.ascontiguousarray(ofs, np.uint32), ctypes.c_uint32), len(lls))
    return int(rc) if rc >= 0 else None


def fast_find_matches(src: np.ndarray, start: int, end: int, window_start: int,
                      window_size: int, table: np.ndarray, hash_log: int,
                      rep: list[int], acceleration: int = 1, mls: int = 4):
    lib = get_lib()
    if lib is None:
        return None
    max_seq = max((end - start) // 3 + 8, 16)
    out_ll = np.empty(max_seq, dtype=np.uint32)
    out_ml = np.empty(max_seq, dtype=np.uint32)
    out_ob = np.empty(max_seq, dtype=np.uint32)
    rep_arr = np.array(rep[:2], dtype=np.uint32)
    last_lit = np.zeros(1, dtype=np.int64)
    n = lib.fast_find_matches(
        _ptr(src, ctypes.c_uint8), len(src), start, end, window_start,
        window_size, _ptr(table, ctypes.c_int64), hash_log,
        max(4, min(8, mls)), _ptr(rep_arr, ctypes.c_uint32),
        _ptr(out_ll, ctypes.c_uint32), _ptr(out_ml, ctypes.c_uint32),
        _ptr(out_ob, ctypes.c_uint32), max_seq,
        _ptr(last_lit, ctypes.c_int64), acceleration)
    if n < 0:
        return None
    rep[0], rep[1] = int(rep_arr[0]), int(rep_arr[1])
    return out_ll[:n], out_ml[:n], out_ob[:n], int(last_lit[0])


def hybrid_select(src: np.ndarray, n_valid: int, cand: np.ndarray,
                  rep: list[int]):
    """Greedy selection over device-computed candidates (one block)."""
    lib = get_lib()
    if lib is None:
        return None
    max_seq = max(n_valid // 3 + 8, 16)
    out_ll = np.empty(max_seq, dtype=np.uint32)
    out_ml = np.empty(max_seq, dtype=np.uint32)
    out_ob = np.empty(max_seq, dtype=np.uint32)
    rep_arr = np.array(rep[:2], dtype=np.uint32)
    last_lit = np.zeros(1, dtype=np.int64)
    n = lib.hybrid_select(
        _ptr(np.ascontiguousarray(src, np.uint8), ctypes.c_uint8), n_valid,
        _ptr(np.ascontiguousarray(cand, np.int32), ctypes.c_int32),
        _ptr(rep_arr, ctypes.c_uint32),
        _ptr(out_ll, ctypes.c_uint32), _ptr(out_ml, ctypes.c_uint32),
        _ptr(out_ob, ctypes.c_uint32), max_seq,
        _ptr(last_lit, ctypes.c_int64))
    if n < 0:
        return None
    rep[0], rep[1] = int(rep_arr[0]), int(rep_arr[1])
    return out_ll[:n], out_ml[:n], out_ob[:n], int(last_lit[0])


def dp_frame_body(src: np.ndarray, cand: np.ndarray,
                  block_size: int) -> bytes | None:
    """One-pass DP frame body: hybrid selection over device candidates +
    exact-path entropy per block, all native (zt_dp_frame_body)."""
    lib = get_lib()
    if lib is None or len(src) == 0:
        return None
    cap = len(src) + (len(src) >> 2) + 4096
    out = np.empty(cap, dtype=np.uint8)
    n = lib.zt_dp_frame_body(
        _ptr(np.ascontiguousarray(src, np.uint8), ctypes.c_uint8), len(src),
        _ptr(np.ascontiguousarray(cand, np.int32), ctypes.c_int32),
        block_size, _ptr(out, ctypes.c_uint8), cap)
    if n < 0:
        return None
    return out[:n].tobytes()


def lazy_find_matches(src: np.ndarray, start: int, end: int, window_start: int,
                      window_size: int, table: np.ndarray, hash_log: int,
                      chain: np.ndarray, attempts: int, depth: int,
                      insert_from: int, rep: list[int], mls: int = 4):
    lib = get_lib()
    if lib is None:
        return None
    max_seq = max((end - start) // 3 + 8, 16)
    out_ll = np.empty(max_seq, dtype=np.uint32)
    out_ml = np.empty(max_seq, dtype=np.uint32)
    out_ob = np.empty(max_seq, dtype=np.uint32)
    rep_arr = np.array(rep[:2], dtype=np.uint32)
    last_lit = np.zeros(1, dtype=np.int64)
    ins = np.array([insert_from], dtype=np.int64)
    n = lib.lazy_find_matches(
        _ptr(src, ctypes.c_uint8), len(src), start, end, window_start,
        window_size, _ptr(table, ctypes.c_int64), hash_log,
        _ptr(chain, ctypes.c_int64), len(chain), attempts, depth,
        _ptr(ins, ctypes.c_int64), _ptr(rep_arr, ctypes.c_uint32),
        _ptr(out_ll, ctypes.c_uint32), _ptr(out_ml, ctypes.c_uint32),
        _ptr(out_ob, ctypes.c_uint32), max_seq,
        _ptr(last_lit, ctypes.c_int64), max(4, min(8, mls)))
    if n < 0:
        return None
    rep[0], rep[1] = int(rep_arr[0]), int(rep_arr[1])
    return out_ll[:n], out_ml[:n], out_ob[:n], int(last_lit[0]), int(ins[0])


def encode_sequences(lls, mls_minus3, obs, llc, mlc, ofc, ll_bits, ml_bits,
                     ll_ct, of_ct, ml_ct) -> bytes | None:
    lib = get_lib()
    if lib is None:
        return None
    n = len(lls)
    cap = 32 + n * 16
    out = np.empty(cap, dtype=np.uint8)

    holds = []  # keep padded arrays alive across the native call

    def ctbl(ct):
        # The native fused-table prebuild reads the FULL alphabet range
        # (36/53/32 entries); tables built for a smaller max symbol must be
        # padded or the read runs past the buffer (ASan find, round 3).
        dnb = np.ascontiguousarray(ct.delta_nb_bits, np.uint32)
        dfs = np.ascontiguousarray(ct.delta_find_state, np.int32)
        if len(dnb) < 53:
            dnb = np.concatenate([dnb, np.zeros(53 - len(dnb), np.uint32)])
        if len(dfs) < 53:
            dfs = np.concatenate([dfs, np.zeros(53 - len(dfs), np.int32)])
        st = np.ascontiguousarray(ct.state_table, np.uint16)
        holds.extend((dnb, dfs, st))
        return (_ptr(st, ctypes.c_uint16),
                _ptr(dnb, ctypes.c_uint32),
                _ptr(dfs, ctypes.c_int32),
                ct.table_log)

    size = lib.encode_sequences(
        _ptr(np.ascontiguousarray(lls, np.uint32), ctypes.c_uint32),
        _ptr(np.ascontiguousarray(mls_minus3, np.uint32), ctypes.c_uint32),
        _ptr(np.ascontiguousarray(obs, np.uint32), ctypes.c_uint32),
        _ptr(np.ascontiguousarray(llc, np.uint8), ctypes.c_uint8),
        _ptr(np.ascontiguousarray(mlc, np.uint8), ctypes.c_uint8),
        _ptr(np.ascontiguousarray(ofc, np.uint8), ctypes.c_uint8),
        _ptr(np.ascontiguousarray(ll_bits, np.uint8), ctypes.c_uint8),
        _ptr(np.ascontiguousarray(ml_bits, np.uint8), ctypes.c_uint8),
        n, *ctbl(ll_ct), *ctbl(of_ct), *ctbl(ml_ct),
        _ptr(out, ctypes.c_uint8), cap)
    if size < 0:
        return None
    return out[:size].tobytes()


def huf_encode_stream(symbols: np.ndarray, code: np.ndarray,
                      nbits: np.ndarray) -> bytes | None:
    lib = get_lib()
    if lib is None:
        return None
    symbols = np.ascontiguousarray(symbols, np.uint8)
    cap = 16 + len(symbols) * 2
    out = np.empty(cap, dtype=np.uint8)
    size = lib.huf_encode_stream(
        _ptr(symbols, ctypes.c_uint8), len(symbols),
        _ptr(np.ascontiguousarray(code, np.uint16), ctypes.c_uint16),
        _ptr(np.ascontiguousarray(nbits, np.uint8), ctypes.c_uint8),
        _ptr(out, ctypes.c_uint8), cap)
    if size < 0:
        return None
    return out[:size].tobytes()


def compress_frame_body(src: np.ndarray, strategy: int, hash_log: int,
                        chain_log: int, search_log: int, window_log: int,
                        accel: int = 1, use_ldm: bool = False,
                        min_match: int = 4, block_splitter: bool = True,
                        target_cblock: int = 0) -> bytes | None:
    """Whole-frame native encode (all blocks, no frame header/checksum)."""
    lib = get_lib()
    if lib is None:
        return None
    n = len(src)
    cap = n + (n >> 6) + 4096
    out = np.empty(cap, dtype=np.uint8)
    size = lib.compress_frame_body_ldm_c(
        _ptr(np.ascontiguousarray(src, np.uint8), ctypes.c_uint8), n,
        strategy, hash_log, chain_log, search_log, window_log, accel,
        int(use_ldm), min_match, int(block_splitter), target_cblock,
        _ptr(out, ctypes.c_uint8), cap)
    if size < 0:
        return None
    return out[:size].tobytes()


class NativeEStream:
    """Resumable streaming encoder context (zt_estream_*): emits frame-body
    block bytes at native speed; the Python FrameEncoder keeps the frame
    header, checksum, and windowing contract."""

    def __init__(self, strategy: int, hash_log: int, chain_log: int,
                 search_log: int, window_log: int, min_match: int,
                 accel: int = 1, tcbs: int = 0, ldm: int = 0):
        self._lib = get_lib()
        self._h = None
        if self._lib is None:
            raise RuntimeError("native library unavailable")
        self._h = self._lib.zt_estream_new2(strategy, hash_log, chain_log,
                                            search_log, window_log,
                                            min_match, accel, tcbs, ldm)
        if not self._h:
            raise RuntimeError("zt_estream_new failed")
        self._pending = 0  # uncompressed bytes buffered in the ctx

    def preload(self, dict_data: bytes) -> None:
        """Seed the context with a dictionary (prefix history + matcher
        table prefill + repcode/entropy seed) — must precede any feed."""
        arr = np.frombuffer(bytes(dict_data), np.uint8)
        rc = self._lib.zt_estream_preload(
            self._h, _ptr(arr, ctypes.c_uint8), len(arr))
        if rc < 0:
            raise RuntimeError("zt_estream_preload failed")

    def feed(self, data: np.ndarray, mode: int) -> bytes:
        """mode: 0 accumulate, 1 flush pending, 2 end (writes last block)."""
        n = len(data)
        total = self._pending + n
        cap = total + (total >> 6) + (1 << 18)
        out = np.empty(cap, dtype=np.uint8)
        arr = np.ascontiguousarray(data, np.uint8)
        size = self._lib.zt_estream_feed(
            self._h, _ptr(arr, ctypes.c_uint8), n, mode,
            _ptr(out, ctypes.c_uint8), cap)
        if size < 0:
            raise RuntimeError("zt_estream_feed failed")
        self._pending = int(self._lib.zt_estream_pending(self._h))
        return out[:size].tobytes()

    @property
    def pending(self) -> int:
        return self._pending

    def close(self) -> None:
        if self._h:
            self._lib.zt_estream_free(self._h)
            self._h = None

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass


class NativeDStream:
    """Persistent per-frame decode state (entropy tables + repcodes) for the
    streaming stage machine; one zt_dstream_block call per compressed
    block, writing into the caller's window buffer."""

    def __init__(self):
        self._lib = get_lib()
        self._h = None
        if self._lib is None:
            raise RuntimeError("native library unavailable")
        self._h = self._lib.zt_dstream_new()
        if not self._h:
            raise RuntimeError("zt_dstream_new failed")

    def block(self, body: bytes, out: np.ndarray, out_pos: int,
              prefix_start: int = 0) -> int:
        arr = np.frombuffer(body, dtype=np.uint8)
        r = self._lib.zt_dstream_block(
            self._h, _ptr(arr, ctypes.c_uint8), len(body),
            _ptr(out, ctypes.c_uint8), out_pos, len(out), prefix_start)
        return int(r)

    def drain(self, src, out: np.ndarray, out_pos: int,
              prefix_start: int = 0) -> tuple[int, int, bool]:
        """Decode every complete block in src; returns
        (new_out_pos, consumed_input, saw_last).  src may be any
        buffer-protocol object (bytes, bytearray slice, memoryview)."""
        arr = np.frombuffer(src, dtype=np.uint8)
        consumed = ctypes.c_int64(0)
        saw_last = ctypes.c_int(0)
        r = self._lib.zt_dstream_drain(
            self._h, _ptr(arr, ctypes.c_uint8), len(arr),
            _ptr(out, ctypes.c_uint8), out_pos, len(out), prefix_start,
            ctypes.byref(consumed), ctypes.byref(saw_last))
        return int(r), int(consumed.value), bool(saw_last.value)

    def close(self) -> None:
        if self._h:
            self._lib.zt_dstream_free(self._h)
            self._h = None

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass


def decode_frame_body(src: bytes | np.ndarray, out_cap: int):
    """Whole-frame native decode (after frame header, before checksum).

    Returns (content np.uint8, consumed) or None on failure/unsupported.
    """
    lib = get_lib()
    if lib is None:
        return None
    arr = (np.frombuffer(src, dtype=np.uint8) if not isinstance(src, np.ndarray)
           else np.ascontiguousarray(src, np.uint8))
    out = np.empty(out_cap, dtype=np.uint8)
    consumed = np.zeros(1, dtype=np.int64)
    produced = lib.decode_frame_body_c(
        _ptr(arr, ctypes.c_uint8), len(arr), _ptr(out, ctypes.c_uint8),
        out_cap, _ptr(consumed, ctypes.c_int64))
    if produced < 0:
        return None
    return out[:produced], int(consumed[0])


def xxh64(data: bytes, seed: int = 0) -> int | None:
    lib = get_lib()
    if lib is None:
        return None
    arr = np.frombuffer(data, dtype=np.uint8)
    return int(lib.xxh64(_ptr(arr, ctypes.c_uint8), len(arr), seed))


class NativeCDict:
    """Owned handle to a native compression dictionary context
    (ZSTD_CDict role): prefilled matcher tables + entropy seed."""

    def __init__(self, dict_raw: bytes, strategy: int, hash_log: int,
                 chain_log: int, search_log: int, window_log: int,
                 min_match: int):
        self._lib = get_lib()
        self._h = None
        # The native CDictC keeps per-call scratch (working buffer, local
        # table, entropy snapshot) in the handle; ctypes releases the GIL, so
        # concurrent wrap() calls on one dictionary must serialize here (the
        # reference ZSTD_CDict is immutable and needs no lock).
        self._mtx = threading.Lock()
        if self._lib is None:
            return
        raw = np.frombuffer(bytes(dict_raw), dtype=np.uint8)
        self._raw = raw  # keep alive during create
        self._h = self._lib.zt_cdict_create(
            _ptr(raw, ctypes.c_uint8), len(raw), strategy, hash_log,
            chain_log, search_log, window_log, min_match)

    @property
    def valid(self) -> bool:
        return bool(self._h)

    def entropy_stats(self, records: list[bytes]):
        """Histogram the attach-parse of records vs this dictionary
        (ZDICT_countEStats role): returns (lit, ll, ml, of, rep_off)
        int64 count arrays or None."""
        if not self._h:
            return None
        concat = np.frombuffer(b"".join(records), dtype=np.uint8)
        lens = np.array([len(r) for r in records], dtype=np.int64)
        lit = np.zeros(256, np.int64)
        ll = np.zeros(36, np.int64)
        ml = np.zeros(53, np.int64)
        of = np.zeros(29, np.int64)
        rep = np.zeros(1024, np.int64)
        with self._mtx:
            rc = self._lib.zt_cdict_stats(
                self._h, _ptr(concat, ctypes.c_uint8),
                _ptr(lens, ctypes.c_int64), len(records),
                _ptr(lit, ctypes.c_int64), _ptr(ll, ctypes.c_int64),
                _ptr(ml, ctypes.c_int64), _ptr(of, ctypes.c_int64),
                _ptr(rep, ctypes.c_int64))
        if rc != 0:
            return None
        return lit, ll, ml, of, rep

    def compress_many(self, records: list[bytes], dict_id: int) -> list[bytes] | None:
        """Batch wrap: one native call for the whole record list."""
        if not self._h:
            return None
        concat = np.frombuffer(b"".join(records), dtype=np.uint8)
        lens = np.array([len(r) for r in records], dtype=np.int64)
        cap = int(len(concat) + 64 * len(records) + 4096)
        out = np.empty(cap, dtype=np.uint8)
        out_lens = np.empty(len(records), dtype=np.int64)
        with self._mtx:
            total = self._lib.zt_compress_many_cdict(
                self._h, _ptr(concat, ctypes.c_uint8), _ptr(lens, ctypes.c_int64),
                len(records), dict_id, _ptr(out, ctypes.c_uint8), cap,
                _ptr(out_lens, ctypes.c_int64))
        if total < 0:
            return None
        res = []
        off = 0
        raw = out[: int(total)].tobytes()
        for ln in out_lens.tolist():
            res.append(raw[off : off + ln])
            off += ln
        return res

    def compress_frame_body(self, src: np.ndarray) -> bytes | None:
        if not self._h or len(src) == 0:
            return None
        n = len(src)
        cap = n + (n >> 6) + 4096
        out = np.empty(cap, dtype=np.uint8)
        with self._mtx:
            size = self._lib.zt_compress_frame_body_cdict(
                self._h, _ptr(np.ascontiguousarray(src, np.uint8), ctypes.c_uint8),
                n, _ptr(out, ctypes.c_uint8), cap)
        if size < 0:
            return None
        return out[:size].tobytes()

    def __del__(self):
        if getattr(self, "_h", None) and self._lib is not None:
            self._lib.zt_cdict_free(self._h)
            self._h = None


class NativeDDict:
    """Owned handle to a native decompression dictionary context
    (ZSTD_DDict role): content history + preloaded entropy tables."""

    def __init__(self, dict_raw: bytes):
        self._lib = get_lib()
        self._h = None
        self.content_len = 0
        self.last_fallback_count = 0
        # DDictC keeps a per-call entropy scratch in the handle (dirty-
        # restored); serialize concurrent unwrap() calls on one dictionary.
        self._mtx = threading.Lock()
        if self._lib is None:
            return
        raw = np.frombuffer(bytes(dict_raw), dtype=np.uint8)
        self._h = self._lib.zt_ddict_create(_ptr(raw, ctypes.c_uint8), len(raw))
        if self._h:
            # content length = dict minus header (recomputed python-side)
            from .dictionary import parse_dictionary

            self.content_len = len(parse_dictionary(bytes(dict_raw)).content)

    @property
    def valid(self) -> bool:
        return bool(self._h)

    def decompress_many(self, frames: list[bytes],
                        expect_dict_id: int = 0,
                        fallback=None) -> list[bytes] | None:
        """Batch unwrap: one native call for the whole frame list (frames
        must carry a known content size; checksums are verified natively).
        A frame the native path cannot decode (unknown size, wrong dictID,
        bad checksum...) is handed to `fallback(frame_bytes)` — the
        caller's element-wise decoder, which raises the proper error — and
        the batch resumes natively after it (ZstdDecompress.cs:1216
        multi-frame loop role: one frame's failure stays local).  Without
        a fallback any failure returns None.  After a call,
        `last_fallback_count` says how many frames left the native path
        (bench honesty: a silent mass fallback must be visible)."""
        self.last_fallback_count = 0
        if not self._h:
            return None
        results: list[bytes] = [b""] * len(frames)
        start = 0
        while start < len(frames):
            sub = frames[start:]
            concat = np.frombuffer(b"".join(sub), dtype=np.uint8)
            flens = np.array([len(f) for f in sub], dtype=np.int64)
            cap = int(len(concat) * 64 + (1 << 20))
            out = np.empty(cap, dtype=np.uint8)
            out_lens = np.empty(len(sub), dtype=np.int64)
            with self._mtx:
                total = self._lib.zt_decompress_many_ddict(
                    self._h, _ptr(concat, ctypes.c_uint8),
                    _ptr(flens, ctypes.c_int64),
                    len(sub), expect_dict_id, _ptr(out, ctypes.c_uint8), cap,
                    _ptr(out_lens, ctypes.c_int64))
            if total >= 0:
                raw = out[: int(total)].tobytes()
                off = 0
                for j, ln in enumerate(out_lens.tolist()):
                    results[start + j] = raw[off : off + ln]
                    off += ln
                return results
            failed = -int(total) - 2  # index within `sub`, or -1 for -1
            if failed < 0 or failed >= len(sub) or fallback is None:
                return None
            lens_ok = out_lens.tolist()[:failed]
            raw = out[: sum(lens_ok)].tobytes()
            off = 0
            for j, ln in enumerate(lens_ok):
                results[start + j] = raw[off : off + ln]
                off += ln
            # element-wise decode of the one frame the native batch cannot
            # serve; errors (dictionary_wrong, checksum...) propagate.
            results[start + failed] = fallback(sub[failed])
            self.last_fallback_count += 1
            start += failed + 1
        return results

    def decode_frame_body(self, src: np.ndarray, content_cap: int):
        """Returns (content np.uint8, consumed) or None."""
        if not self._h:
            return None
        arr = np.ascontiguousarray(src, np.uint8)
        cap = self.content_len + content_cap + 64
        out = np.empty(cap, dtype=np.uint8)
        consumed = np.zeros(1, dtype=np.int64)
        with self._mtx:
            size = self._lib.zt_decode_frame_body_ddict(
                _ptr(arr, ctypes.c_uint8), len(arr), self._h,
                _ptr(out, ctypes.c_uint8), cap, _ptr(consumed, ctypes.c_int64))
        if size < 0:
            return None
        return out[self.content_len : self.content_len + size], int(consumed[0])

    def __del__(self):
        if getattr(self, "_h", None) and self._lib is not None:
            self._lib.zt_ddict_free(self._h)
            self._h = None


def compress_exact(data: bytes, level: int, checksum: bool = False) -> bytes | None:
    """Byte-exact zstd frame via the native exact encoder
    (ZSTD_compress2 semantics for the fast/dfast and bt-optimal
    strategies, ZstdFast.cs:96 / ZstdDoubleFast.cs:51 / ZstdOpt.cs:1046).
    Returns None when unavailable or the level/size routes to an
    unsupported strategy (caller falls back to the generic pipeline)."""
    ext = get_ext()
    if ext is not None:
        # zero-copy: the frame is written straight into the returned bytes
        return ext.compress_exact(data, level, bool(checksum))
    lib = get_lib()
    if lib is None:
        return None
    src = np.frombuffer(data, dtype=np.uint8)
    cap = len(src) + (len(src) >> 2) + 4096
    out = np.empty(cap, dtype=np.uint8)
    size = lib.zt_compress_exact(
        _ptr(src, ctypes.c_uint8), len(src), level, 1 if checksum else 0,
        _ptr(out, ctypes.c_uint8), cap)
    if size < 0:
        return None
    return out[:size].tobytes()

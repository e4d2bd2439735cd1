"""ctypes bindings to the C++ CPU oracle (cpp/).

The oracle is the bit-exact differential-testing reference and the fast
host path (SURVEY.md §2.1 "ours" column). Parity target: the whole
reference crate's native surface. The library is built from the
committed sources at first use (``build()``), into
``cpp/build/<key>/``, where the key hashes the host CPU's model and
flags, the compiler flags and every source byte: a library built on
another machine, or from other sources, is never loaded. Set
TPZ_ORACLE_LIB to load a prebuilt library instead (e.g. the ASan build).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

import numpy as np

from tpz.errors import STATUS_BUFFER_TOO_SMALL, raise_for_status

_LIB = None
_LIB_ERROR = None  # a failed build is reported, not retried, per process
_CPP = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "cpp")
_SOURCES = ("huffman.cc", "lzss.cc", "deflate.cc", "checksums.cc",
            "lzhuf.cc", "bzip2.cc", "capi.cc")
_HEADERS = ("bitio.h", "huffman.h", "lzss.h", "deflate.h", "lzhuf.h",
            "bzip2.h")
_CXXFLAGS = ("-O3", "-std=c++17", "-fPIC", "-march=native", "-pthread",
             "-Wno-unused-parameter")


def _host_tag() -> bytes:
    """The host CPU's model name and feature flags (-march=native code
    may not run on another CPU)."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            lines = f.read().split(b"\n")
    except OSError:
        import platform

        return platform.processor().encode()
    keep = {}
    for ln in lines:
        k = ln.split(b":", 1)[0].strip()
        if k in (b"model name", b"flags", b"Features") and k not in keep:
            keep[k] = ln
    return b"|".join(keep[k] for k in sorted(keep))


def _generated_header() -> str:
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "_tpz_gen_constants", os.path.join(_CPP, "gen_constants.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.render()


def build() -> str:
    """Path of the oracle library for this host and these sources,
    compiling it first if needed. Concurrent callers (test workers,
    processes sharing a checkout) serialize on a file lock; the library
    appears under its final name only when complete."""
    import fcntl
    import tempfile

    gen = _generated_header()
    h = hashlib.sha256(_host_tag())
    h.update(" ".join(_CXXFLAGS).encode())
    h.update(gen.encode())
    for name in _SOURCES + _HEADERS:
        with open(os.path.join(_CPP, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    out_dir = os.path.join(_CPP, "build", h.hexdigest()[:16])
    path = os.path.join(out_dir, "libtpz_oracle.so")
    if os.path.exists(path):
        return path
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(path):
            return path
        with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
            # Compile copies of the sources next to the generated header,
            # so their quoted includes resolve inside this build only.
            for name in _SOURCES + _HEADERS:
                with open(os.path.join(_CPP, name), "rb") as f:
                    data = f.read()
                with open(os.path.join(tmp, name), "wb") as f:
                    f.write(data)
            with open(os.path.join(tmp, "generated_constants.h"), "w") as f:
                f.write(gen)
            cxx = os.environ.get("CXX", "g++")
            procs = [subprocess.Popen(
                [cxx, *_CXXFLAGS, "-c", name, "-o", name + ".o"], cwd=tmp,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
                for name in _SOURCES]
            for name, p in zip(_SOURCES, procs):
                log = p.communicate()[0]
                if p.returncode != 0:
                    raise RuntimeError(f"oracle build failed on {name}:\n"
                                       + log.decode(errors="replace"))
            subprocess.run(
                [cxx, *_CXXFLAGS, "-shared", "-o", "lib.so",
                 *(n + ".o" for n in _SOURCES)], cwd=tmp, check=True,
                capture_output=True)
            os.replace(os.path.join(tmp, "lib.so"), path)
    return path


def _find_lib() -> str:
    return os.environ.get("TPZ_ORACLE_LIB") or build()


def lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        global _LIB_ERROR
        if _LIB_ERROR is None:
            try:
                path = _find_lib()
                if not os.path.exists(path):
                    raise RuntimeError(f"oracle library not found at {path}")
            except (OSError, RuntimeError,
                    subprocess.CalledProcessError) as e:
                _LIB_ERROR = f"oracle library unavailable: {e}"
        if _LIB_ERROR is not None:
            raise RuntimeError(_LIB_ERROR)
        L = ctypes.CDLL(path)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i32p = ctypes.POINTER(ctypes.c_int32)
        u32p = ctypes.POINTER(ctypes.c_uint32)
        u16p = ctypes.POINTER(ctypes.c_uint16)
        szp = ctypes.POINTER(ctypes.c_size_t)
        L.tpz_crc32_reflected.restype = ctypes.c_uint32
        L.tpz_crc32_reflected.argtypes = [u8p, ctypes.c_size_t, ctypes.c_uint32]
        L.tpz_crc32_msb.restype = ctypes.c_uint32
        L.tpz_crc32_msb.argtypes = [u8p, ctypes.c_size_t, ctypes.c_uint32]
        L.tpz_adler32.restype = ctypes.c_uint32
        L.tpz_adler32.argtypes = [u8p, ctypes.c_size_t, ctypes.c_uint32]
        L.tpz_huff_lengths.restype = ctypes.c_int
        L.tpz_huff_lengths.argtypes = [u32p, ctypes.c_int32, ctypes.c_int32, u8p]
        L.tpz_huff_canonical.restype = None
        L.tpz_huff_canonical.argtypes = [u8p, ctypes.c_int32, u32p]
        L.tpz_lzss_tokenize.restype = ctypes.c_int
        L.tpz_lzss_tokenize.argtypes = [u8p, ctypes.c_size_t, i32p, i32p, szp]
        L.tpz_deflate_encode.restype = ctypes.c_int
        L.tpz_deflate_encode.argtypes = [u8p, ctypes.c_size_t, i32p, u8p, szp]
        L.tpz_deflate_encode_block.restype = ctypes.c_int
        L.tpz_deflate_encode_block.argtypes = [
            u8p, ctypes.c_size_t, i32p, ctypes.c_size_t, ctypes.c_int32, u8p, szp]
        L.tpz_inflate.restype = ctypes.c_int
        L.tpz_inflate.argtypes = [u8p, ctypes.c_size_t, u8p, szp, szp]
        L.tpz_bzip2_encode.restype = ctypes.c_int
        L.tpz_bzip2_encode.argtypes = [
            u8p, ctypes.c_size_t, ctypes.c_int32, u8p, szp]
        L.tpz_bzip2_decode.restype = ctypes.c_int
        L.tpz_bzip2_decode.argtypes = [u8p, ctypes.c_size_t, u8p, szp]
        L.tpz_lzhuf_encode.restype = ctypes.c_int
        L.tpz_lzhuf_encode.argtypes = [
            u8p, ctypes.c_size_t, ctypes.c_int32, ctypes.c_int32, u8p, szp]
        L.tpz_lzhuf_encode_tokens.restype = ctypes.c_int
        L.tpz_lzhuf_encode_tokens.argtypes = [
            i32p, ctypes.c_size_t, ctypes.c_int32, u8p, szp]
        L.tpz_lzhuf_decode.restype = ctypes.c_int
        L.tpz_lzhuf_decode.argtypes = [
            u8p, ctypes.c_size_t, ctypes.c_int32, ctypes.c_size_t, u8p, szp]
        i64p = ctypes.POINTER(ctypes.c_int64)
        L.tpz_bzip2_rle1.restype = ctypes.c_int
        L.tpz_bzip2_rle1.argtypes = [
            u8p, ctypes.c_size_t, ctypes.c_int32, u8p, szp,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
            u32p, i32p]
        L.tpz_bzip2_assemble.restype = ctypes.c_int
        L.tpz_bzip2_assemble.argtypes = [
            u8p, ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64), u32p, u32p, ctypes.c_int32,
            ctypes.c_int32, u8p, szp]
        L.tpz_bzip2_assemble_mtf.restype = ctypes.c_int
        L.tpz_bzip2_assemble_mtf.argtypes = [
            ctypes.POINTER(ctypes.c_uint16), ctypes.POINTER(ctypes.c_int64),
            i32p, u8p, u32p, u32p, ctypes.c_int32, ctypes.c_int32, u8p, szp]
        L.tpz_bwt_ref.restype = ctypes.c_uint32
        L.tpz_bwt_ref.argtypes = [u8p, ctypes.c_size_t, u8p]
        L.tpz_bzip2_scan_to_last.restype = ctypes.c_int
        L.tpz_bzip2_scan_to_last.argtypes = [
            u8p, ctypes.c_size_t, u8p, ctypes.c_int64, i64p, i64p,
            u32p, u32p, i32p]
        L.tpz_bzip2_rle1_inverse.restype = ctypes.c_int
        L.tpz_bzip2_rle1_inverse.argtypes = [
            u8p, i64p, i64p, u32p, ctypes.c_int32, u8p, szp]
        L.tpz_lzhuf_plan.restype = ctypes.c_int
        L.tpz_lzhuf_plan.argtypes = [
            u32p, u32p, u32p, ctypes.c_int32, ctypes.c_int32, i64p, i64p,
            u8p, u16p, u8p, u16p, u8p, ctypes.c_size_t]
        L.tpz_inflate_many.restype = ctypes.c_int
        L.tpz_inflate_many.argtypes = [
            u8p, i64p, i64p, ctypes.c_int32, u8p, i64p, i64p,
            ctypes.c_int32]
        L.tpz_deflate_encode_many.restype = ctypes.c_int
        L.tpz_deflate_encode_many.argtypes = [
            u8p, i64p, i64p, ctypes.c_int32, i32p, u8p, i64p, i64p,
            ctypes.c_int32]
        L.tpz_deflate_plan.restype = ctypes.c_int
        L.tpz_deflate_plan.argtypes = [
            u32p, u32p, i64p, ctypes.c_int32, i32p, i64p, i64p, i64p,
            u8p, u16p, u8p, u16p, u8p, ctypes.c_size_t]
        L.tpz_inflate_scan_headers.restype = ctypes.c_int
        L.tpz_inflate_scan_headers.argtypes = [
            u8p, ctypes.c_size_t, i64p, ctypes.c_int32, i32p, i64p,
            i32p, i32p, i32p, i32p, i32p, i32p, u32p, u32p]
        L.tpz_lzhuf_index.restype = ctypes.c_int
        L.tpz_lzhuf_index.argtypes = [
            u8p, ctypes.c_size_t, ctypes.c_int32, ctypes.c_size_t,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, i64p, i64p,
            i64p, i32p, i32p, i32p, u8p, u8p, i32p, i32p, i64p, i64p]
        L.tpz_bzip2_scan_headers.restype = ctypes.c_int
        L.tpz_bzip2_scan_headers.argtypes = [
            u8p, ctypes.c_size_t, ctypes.c_int32, i64p, i64p, u32p, u32p,
            i32p, i32p, i32p, u8p, u8p, u8p, i32p]
        L.tpz_inflate_scan_segments.restype = ctypes.c_int
        L.tpz_inflate_scan_segments.argtypes = [
            u8p, ctypes.c_size_t, i64p, i64p, i64p, ctypes.c_int32, i32p,
            i64p, i32p, i32p, i32p, i32p, i32p, i32p, u32p, u32p]
        L.tpz_inflate_index.restype = ctypes.c_int
        L.tpz_inflate_index.argtypes = [
            u8p, ctypes.c_size_t, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, i64p, i64p, i64p, i64p, i32p, i32p, i64p, szp]
        L.tpz_deflate_encode_flush.restype = ctypes.c_int
        L.tpz_deflate_encode_flush.argtypes = [
            u8p, ctypes.c_size_t, i32p, u8p, szp]
        L.tpz_inflate_stream_new.restype = ctypes.c_void_p
        L.tpz_inflate_stream_new.argtypes = []
        L.tpz_inflate_stream_free.restype = None
        L.tpz_inflate_stream_free.argtypes = [ctypes.c_void_p]
        L.tpz_inflate_stream_feed.restype = ctypes.c_int
        L.tpz_inflate_stream_feed.argtypes = [
            ctypes.c_void_p, u8p, ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_int32), i64p, i64p]
        L.tpz_inflate_stream_take.restype = ctypes.c_int64
        L.tpz_inflate_stream_take.argtypes = [
            ctypes.c_void_p, u8p, ctypes.c_int64]
        L.tpz_lzhuf_stream_new.restype = ctypes.c_void_p
        L.tpz_lzhuf_stream_new.argtypes = [ctypes.c_int32, ctypes.c_uint64]
        L.tpz_lzhuf_stream_free.restype = None
        L.tpz_lzhuf_stream_free.argtypes = [ctypes.c_void_p]
        L.tpz_lzhuf_stream_feed.restype = ctypes.c_int
        L.tpz_lzhuf_stream_feed.argtypes = [
            ctypes.c_void_p, u8p, ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_int32), i64p]
        L.tpz_lzhuf_stream_take.restype = ctypes.c_int64
        L.tpz_lzhuf_stream_take.argtypes = [
            ctypes.c_void_p, u8p, ctypes.c_int64]
        L.tpz_lzss_pack.restype = ctypes.c_int
        L.tpz_lzss_pack.argtypes = [
            i32p, ctypes.c_size_t, ctypes.c_int32, u8p, szp]
        L.tpz_lzss_unpack.restype = ctypes.c_int
        L.tpz_lzss_unpack.argtypes = [
            u8p, ctypes.c_size_t, ctypes.c_int64, ctypes.c_int32, u8p, szp]
        _LIB = L
    return _LIB


def available() -> bool:
    try:
        lib()
        return True
    except RuntimeError:
        return False


def _u8(data) -> np.ndarray:
    if isinstance(data, np.ndarray):
        return np.ascontiguousarray(data, dtype=np.uint8)
    return np.frombuffer(memoryview(bytes(data)), dtype=np.uint8)


def _ptr(a: np.ndarray, typ):
    return a.ctypes.data_as(ctypes.POINTER(typ))


_DUMMY = np.zeros(1, dtype=np.uint8)  # valid pointer for empty buffers


def _u8ptr(a: np.ndarray):
    if a.size == 0:
        return _ptr(_DUMMY, ctypes.c_uint8)
    return _ptr(a, ctypes.c_uint8)


def crc32_reflected(data, state: int = 0xFFFFFFFF) -> int:
    a = _u8(data)
    return int(lib().tpz_crc32_reflected(_u8ptr(a), a.size, state))


def crc32_msb(data, state: int = 0xFFFFFFFF) -> int:
    a = _u8(data)
    return int(lib().tpz_crc32_msb(_u8ptr(a), a.size, state))


def adler32(data, state: int = 1) -> int:
    a = _u8(data)
    return int(lib().tpz_adler32(_u8ptr(a), a.size, state))


def huff_lengths(freqs: np.ndarray, limit: int) -> np.ndarray:
    f = np.ascontiguousarray(freqs, dtype=np.uint32)
    out = np.zeros(f.size, dtype=np.uint8)
    st = lib().tpz_huff_lengths(
        _ptr(f, ctypes.c_uint32), f.size, limit, _ptr(out, ctypes.c_uint8))
    raise_for_status(st, "huff_lengths: impossible length limit")
    return out


def huff_canonical(lengths: np.ndarray) -> np.ndarray:
    ln = np.ascontiguousarray(lengths, dtype=np.uint8)
    out = np.zeros(ln.size, dtype=np.uint32)
    lib().tpz_huff_canonical(
        _ptr(ln, ctypes.c_uint8), ln.size, _ptr(out, ctypes.c_uint32))
    return out


def params_array(
    window: int = 32768,
    min_match: int = 3,
    max_match: int = 258,
    max_chain: int = 32,
    hash_bits: int = 15,
    block_size: int = 65536,
    lazy: bool = False,
    too_far_rule: bool = True,
    too_far: int = 4096,
    max_lazy: int = 258,
    n_extend: int = 1,
    screen_bytes: int = 8,
    suffix_mode: bool = False,
    restart: int = 0,
) -> np.ndarray:
    return np.array(
        [window, min_match, max_match, max_chain, hash_bits, block_size,
         int(lazy), int(too_far_rule), too_far, max_lazy, n_extend,
         screen_bytes, int(suffix_mode), restart],
        dtype=np.int32,
    )


def lzss_tokenize(data, params: np.ndarray | None = None) -> np.ndarray:
    """Returns [N, 4] int32 tokens: (pos, len, lit, dist); len==0 ⇒ literal."""
    a = _u8(data)
    p = params if params is not None else params_array()
    p = np.ascontiguousarray(p, dtype=np.int32)
    cap = max(16, a.size + 16)
    toks = np.zeros((cap, 4), dtype=np.int32)
    n = ctypes.c_size_t(cap)
    st = lib().tpz_lzss_tokenize(
        _u8ptr(a), a.size, _ptr(p, ctypes.c_int32),
        _ptr(toks, ctypes.c_int32), ctypes.byref(n))
    raise_for_status(st, "lzss_tokenize")
    return toks[: n.value].copy()


def lzss_pack(tokens: np.ndarray, min_match: int = 3) -> bytes:
    """Serialize [N,4] tokens to the standalone-LZSS tagged-byte stream
    (tpz/codecs/lzss.py format) natively — no per-token Python loop."""
    toks = np.ascontiguousarray(tokens, dtype=np.int32)
    ntok = toks.shape[0] if toks.ndim == 2 else 0
    cap = max(16, 4 * ntok + 16)
    out = np.zeros(cap, dtype=np.uint8)
    n = ctypes.c_size_t(cap)
    st = lib().tpz_lzss_pack(
        _ptr(toks, ctypes.c_int32), ntok, min_match,
        _ptr(out, ctypes.c_uint8), ctypes.byref(n))
    raise_for_status(st, "lzss_pack")
    return out[: n.value].tobytes()


def lzss_unpack(data, orig_size: int, min_match: int = 3) -> bytes:
    """Decode the standalone-LZSS tagged-byte stream natively."""
    a = _u8(data)
    cap = max(16, orig_size)
    out = np.zeros(cap, dtype=np.uint8)
    n = ctypes.c_size_t(cap)
    st = lib().tpz_lzss_unpack(
        _u8ptr(a), a.size, orig_size, min_match,
        _ptr(out, ctypes.c_uint8), ctypes.byref(n))
    raise_for_status(st, "lzss_unpack")
    return out[: n.value].tobytes()


def deflate_encode(data, params: np.ndarray | None = None) -> bytes:
    a = _u8(data)
    p = params if params is not None else params_array()
    p = np.ascontiguousarray(p, dtype=np.int32)
    cap = a.size + (a.size >> 3) + 1024
    out = np.zeros(cap, dtype=np.uint8)
    n = ctypes.c_size_t(cap)
    st = lib().tpz_deflate_encode(
        _u8ptr(a), a.size, _ptr(p, ctypes.c_int32), _ptr(out, ctypes.c_uint8),
        ctypes.byref(n))
    raise_for_status(st, "deflate_encode")
    return out[: n.value].tobytes()


def inflate_scan_headers(stream, end_bits: np.ndarray) -> dict:
    """Header-only decode scan (cpp InflateScanHeaders): per indexed block,
    block type, body bit offset, stored chunk layout, and two-level decode
    tables [nb, INFLATE_LIT_TW]/[nb, INFLATE_DIST_TW] packed
    (sym << 5 | len; len 31 = escape into the 32-entry L2 chunk at
    entry >> 5). lit_bits[b] == -1 marks a device-decline (L2 overflow)."""
    from tpz import constants as C

    a = _u8(stream)
    eb = np.ascontiguousarray(end_bits, dtype=np.int64)
    nb = eb.shape[0]
    btype = np.zeros(nb, np.int32)
    body_bit = np.zeros(nb, np.int64)
    c0p = np.zeros(nb, np.int32)
    c0l = np.zeros(nb, np.int32)
    c1p = np.zeros(nb, np.int32)
    c1l = np.zeros(nb, np.int32)
    lbits = np.zeros(nb, np.int32)
    dbits = np.zeros(nb, np.int32)
    ltab = np.zeros((nb, C.INFLATE_LIT_TW), np.uint32)
    dtab = np.zeros((nb, C.INFLATE_DIST_TW), np.uint32)
    st = lib().tpz_inflate_scan_headers(
        _u8ptr(a), a.size, _ptr(eb, ctypes.c_int64), nb,
        _ptr(btype, ctypes.c_int32), _ptr(body_bit, ctypes.c_int64),
        _ptr(c0p, ctypes.c_int32), _ptr(c0l, ctypes.c_int32),
        _ptr(c1p, ctypes.c_int32), _ptr(c1l, ctypes.c_int32),
        _ptr(lbits, ctypes.c_int32), _ptr(dbits, ctypes.c_int32),
        _ptr(ltab, ctypes.c_uint32), _ptr(dtab, ctypes.c_uint32))
    raise_for_status(st, "inflate_scan_headers")
    return {"btype": btype, "body_bit": body_bit, "c0_pos": c0p,
            "c0_len": c0l, "c1_pos": c1p, "c1_len": c1l,
            "lit_bits": lbits, "dist_bits": dbits, "lit_tab": ltab,
            "dist_tab": dtab}


BZ_SEL_CAP = 18432


def bzip2_scan_headers(data):
    """Header-only scan for the all-device bzip2 decode (cpp
    Bzip2ScanHeaders): per block, symbol-stream bit offset, slice end,
    orig/crc, alphabet, initial MTF list, selectors and the 6x258 code
    lengths. Returns a dict or None on unsupported shapes."""
    from tpz.errors import STATUS_UNEXPECTED

    a = _u8(data)
    cap = max(4, a.size // 100 + 8)
    sym_bits = np.zeros(cap, np.int64)
    end_bits = np.zeros(cap, np.int64)
    origs = np.zeros(cap, np.uint32)
    crcs = np.zeros(cap, np.uint32)
    n_useds = np.zeros(cap, np.int32)
    nts = np.zeros(cap, np.int32)
    nsels = np.zeros(cap, np.int32)
    mtf_init = np.zeros((cap, 256), np.uint8)
    selectors = np.zeros((cap, BZ_SEL_CAP), np.uint8)
    lens = np.zeros((cap, 6, 258), np.uint8)
    nb = np.zeros(1, np.int32)
    st = lib().tpz_bzip2_scan_headers(
        _u8ptr(a), a.size, cap, _ptr(sym_bits, ctypes.c_int64),
        _ptr(end_bits, ctypes.c_int64), _ptr(origs, ctypes.c_uint32),
        _ptr(crcs, ctypes.c_uint32), _ptr(n_useds, ctypes.c_int32),
        _ptr(nts, ctypes.c_int32), _ptr(nsels, ctypes.c_int32),
        _ptr(mtf_init, ctypes.c_uint8), _ptr(selectors, ctypes.c_uint8),
        _ptr(lens, ctypes.c_uint8), _ptr(nb, ctypes.c_int32))
    if st == STATUS_UNEXPECTED:
        return None
    raise_for_status(st, "bzip2_scan_headers")
    k = int(nb[0])
    return {"sym_bits": sym_bits[:k], "end_bits": end_bits[:k],
            "origs": origs[:k], "crcs": crcs[:k], "n_useds": n_useds[:k],
            "nts": nts[:k], "nsels": nsels[:k], "mtf_init": mtf_init[:k],
            "selectors": selectors[:k], "lens": lens[:k]}


def inflate_scan_segments(stream, hdr_bits: np.ndarray,
                          seg_bits: np.ndarray,
                          end_bits: np.ndarray) -> dict:
    """Like inflate_scan_headers, but entries may share a block header
    and start mid-block (segments from inflate_index)."""
    from tpz import constants as C

    a = _u8(stream)
    hb = np.ascontiguousarray(hdr_bits, dtype=np.int64)
    sb = np.ascontiguousarray(seg_bits, dtype=np.int64)
    eb = np.ascontiguousarray(end_bits, dtype=np.int64)
    nb = eb.shape[0]
    btype = np.zeros(nb, np.int32)
    body_bit = np.zeros(nb, np.int64)
    c0p = np.zeros(nb, np.int32)
    c0l = np.zeros(nb, np.int32)
    c1p = np.zeros(nb, np.int32)
    c1l = np.zeros(nb, np.int32)
    lbits = np.zeros(nb, np.int32)
    dbits = np.zeros(nb, np.int32)
    ltab = np.zeros((nb, C.INFLATE_LIT_TW), np.uint32)
    dtab = np.zeros((nb, C.INFLATE_DIST_TW), np.uint32)
    st = lib().tpz_inflate_scan_segments(
        _u8ptr(a), a.size, _ptr(hb, ctypes.c_int64),
        _ptr(sb, ctypes.c_int64), _ptr(eb, ctypes.c_int64), nb,
        _ptr(btype, ctypes.c_int32), _ptr(body_bit, ctypes.c_int64),
        _ptr(c0p, ctypes.c_int32), _ptr(c0l, ctypes.c_int32),
        _ptr(c1p, ctypes.c_int32), _ptr(c1l, ctypes.c_int32),
        _ptr(lbits, ctypes.c_int32), _ptr(dbits, ctypes.c_int32),
        _ptr(ltab, ctypes.c_uint32), _ptr(dtab, ctypes.c_uint32))
    raise_for_status(st, "inflate_scan_segments")
    return {"btype": btype, "body_bit": body_bit, "c0_pos": c0p,
            "c0_len": c0l, "c1_pos": c1p, "c1_len": c1l,
            "lit_bits": lbits, "dist_bits": dbits, "lit_tab": ltab,
            "dist_tab": dtab}


def inflate_index(stream, seg_out: int = 1 << 16,
                  max_span_bytes: int = (1 << 16) + 6144):
    """Token-aligned segment index over ANY raw DEFLATE stream (cpp
    InflateIndex; SURVEY.md §7.4 route 2): one host symbol walk, no
    output materialization. Returns a dict of per-segment arrays
    (hdr_bits, seg_bits, end_bits, out_lens, carry_len, carry_dist,
    consumed) or None when the stream doesn't fit the device path
    (stored blocks, oversized segment spans)."""
    a = _u8(stream)
    max_segs = max(16, 2 * (a.size // 1024) + 64 * 1024)
    hb = np.zeros(max_segs, np.int64)
    sb = np.zeros(max_segs, np.int64)
    eb = np.zeros(max_segs, np.int64)
    ol = np.zeros(max_segs, np.int64)
    cl = np.zeros(max_segs, np.int32)
    cd = np.zeros(max_segs, np.int32)
    nseg = np.zeros(1, np.int64)
    consumed = ctypes.c_size_t(0)
    st = lib().tpz_inflate_index(
        _u8ptr(a), a.size, seg_out, max_segs, max_span_bytes,
        _ptr(hb, ctypes.c_int64), _ptr(sb, ctypes.c_int64),
        _ptr(eb, ctypes.c_int64), _ptr(ol, ctypes.c_int64),
        _ptr(cl, ctypes.c_int32), _ptr(cd, ctypes.c_int32),
        _ptr(nseg, ctypes.c_int64), ctypes.byref(consumed))
    if st != 0:
        return None
    k = int(nseg[0])
    return {"hdr_bits": hb[:k], "seg_bits": sb[:k], "end_bits": eb[:k],
            "out_lens": ol[:k], "carry_len": cl[:k], "carry_dist": cd[:k],
            "consumed": int(consumed.value)}


def deflate_encode_flush(data, params: np.ndarray | None = None) -> bytes:
    """Action::Flush segment: every block BFINAL=0 plus a Z_SYNC_FLUSH
    empty stored block, so segments concatenate into one valid stream."""
    a = _u8(data)
    p = params if params is not None else params_array()
    p = np.ascontiguousarray(p, dtype=np.int32)
    cap = a.size + (a.size >> 3) + 1024
    out = np.zeros(cap, dtype=np.uint8)
    n = ctypes.c_size_t(cap)
    st = lib().tpz_deflate_encode_flush(
        _u8ptr(a), a.size, _ptr(p, ctypes.c_int32), _ptr(out, ctypes.c_uint8),
        ctypes.byref(n))
    raise_for_status(st, "deflate_encode_flush")
    return out[: n.value].tobytes()


def deflate_encode_block(
    block_data, tokens: np.ndarray, bfinal: bool = True
) -> bytes:
    a = _u8(block_data)
    toks = np.ascontiguousarray(tokens, dtype=np.int32)
    ntok = toks.shape[0] if toks.ndim == 2 else 0
    cap = a.size + (a.size >> 3) + 4096
    out = np.zeros(cap, dtype=np.uint8)
    n = ctypes.c_size_t(cap)
    st = lib().tpz_deflate_encode_block(
        _u8ptr(a), a.size,
        _ptr(toks, ctypes.c_int32) if ntok else _ptr(
            np.zeros((1, 4), np.int32), ctypes.c_int32),
        ntok, int(bfinal), _ptr(out, ctypes.c_uint8), ctypes.byref(n))
    raise_for_status(st, "deflate_encode_block")
    return out[: n.value].tobytes()


def _flat_blobs(datas):
    offs = np.zeros(len(datas), dtype=np.int64)
    lens = np.array([len(d) for d in datas], dtype=np.int64)
    offs[1:] = np.cumsum(lens)[:-1]
    blob = np.frombuffer(b"".join(bytes(d) for d in datas), dtype=np.uint8) \
        if datas else np.zeros(0, np.uint8)
    return blob, offs, lens


def inflate_many(streams, caps=None, n_threads: int | None = None):
    """Threaded raw-DEFLATE decode of independent streams (the native
    runtime may thread even though the reference crate is single-threaded;
    SURVEY.md §2.2)."""
    import os as _os

    if not streams:
        return []
    n = len(streams)
    nt = n_threads or min(n, _os.cpu_count() or 1)
    blob, offs, lens = _flat_blobs(streams)
    caps = caps or [max(4096, 80 * len(s) + 1024) for s in streams]
    # Retry while the C side keeps reporting bigger required sizes —
    # progress-based rather than a fixed pass count, since each failing
    # call may only surface the streams that hit the limit before its
    # workers bailed out (ADVICE r1 #3).
    while True:
        out_lens = np.array(caps, dtype=np.int64)
        out_offs = np.zeros(n, dtype=np.int64)
        out_offs[1:] = np.cumsum(out_lens)[:-1]
        out_blob = np.zeros(int(out_lens.sum()), dtype=np.uint8)
        st = lib().tpz_inflate_many(
            _u8ptr(blob), _ptr(offs, ctypes.c_int64),
            _ptr(lens, ctypes.c_int64), n, _ptr(out_blob, ctypes.c_uint8),
            _ptr(out_offs, ctypes.c_int64), _ptr(out_lens, ctypes.c_int64),
            nt)
        if st == STATUS_BUFFER_TOO_SMALL:
            new_caps = [max(c, int(l)) for c, l in zip(caps, out_lens)]
            if new_caps == caps:
                raise_for_status(st, "inflate_many")  # no progress: bail
            caps = new_caps
            continue
        raise_for_status(st, "inflate_many")
        return [out_blob[out_offs[i]:out_offs[i] + out_lens[i]].tobytes()
                for i in range(n)]
    raise_for_status(STATUS_BUFFER_TOO_SMALL, "inflate_many: output cap")


def deflate_encode_many(datas, params: np.ndarray | None = None,
                        n_threads: int | None = None):
    """Threaded raw-DEFLATE encode of independent buffers."""
    import os as _os

    if not datas:
        return []
    n = len(datas)
    nt = n_threads or min(n, _os.cpu_count() or 1)
    p = np.ascontiguousarray(
        params if params is not None else params_array(), dtype=np.int32)
    blob, offs, lens = _flat_blobs(datas)
    out_lens = np.array([len(d) + (len(d) >> 3) + 1024 for d in datas],
                        dtype=np.int64)
    out_offs = np.zeros(n, dtype=np.int64)
    out_offs[1:] = np.cumsum(out_lens)[:-1]
    out_blob = np.zeros(int(out_lens.sum()), dtype=np.uint8)
    st = lib().tpz_deflate_encode_many(
        _u8ptr(blob), _ptr(offs, ctypes.c_int64), _ptr(lens, ctypes.c_int64),
        n, _ptr(p, ctypes.c_int32), _ptr(out_blob, ctypes.c_uint8),
        _ptr(out_offs, ctypes.c_int64), _ptr(out_lens, ctypes.c_int64), nt)
    raise_for_status(st, "deflate_encode_many")
    return [out_blob[out_offs[i]:out_offs[i] + out_lens[i]].tobytes()
            for i in range(n)]


def deflate_plan(lit_freq: np.ndarray, dist_freq: np.ndarray,
                 block_lens: np.ndarray) -> dict:
    """Host planning for the device pipeline (cpp DeflatePlan).

    lit_freq [NB, 288] uint32 (EOB not counted), dist_freq [NB, 30],
    block_lens [NB] int64. Returns dict with btype, body_off, chunk1_off,
    total_bits, tables (codes bit-reversed), and the header byte stream
    (all header bits at absolute offsets, zero elsewhere).
    """
    lf = np.ascontiguousarray(lit_freq, dtype=np.uint32)
    df = np.ascontiguousarray(dist_freq, dtype=np.uint32)
    bl = np.ascontiguousarray(block_lens, dtype=np.int64)
    nb = lf.shape[0]
    btype = np.zeros(nb, dtype=np.int32)
    body_off = np.zeros(nb, dtype=np.int64)
    chunk1_off = np.zeros(nb, dtype=np.int64)
    total_bits = np.zeros(1, dtype=np.int64)
    lit_len = np.zeros((nb, 288), dtype=np.uint8)
    lit_code = np.zeros((nb, 288), dtype=np.uint16)
    dist_len = np.zeros((nb, 30), dtype=np.uint8)
    dist_code = np.zeros((nb, 30), dtype=np.uint16)
    # Header cap: stream upper bound = sum(block_lens) + stored overhead.
    cap = int(bl.sum()) + 64 * nb + 1024
    header = np.zeros(cap, dtype=np.uint8)
    st = lib().tpz_deflate_plan(
        _ptr(lf, ctypes.c_uint32), _ptr(df, ctypes.c_uint32),
        _ptr(bl, ctypes.c_int64), nb,
        _ptr(btype, ctypes.c_int32), _ptr(body_off, ctypes.c_int64),
        _ptr(chunk1_off, ctypes.c_int64), _ptr(total_bits, ctypes.c_int64),
        _ptr(lit_len, ctypes.c_uint8), _ptr(lit_code, ctypes.c_uint16),
        _ptr(dist_len, ctypes.c_uint8), _ptr(dist_code, ctypes.c_uint16),
        _ptr(header, ctypes.c_uint8), cap)
    raise_for_status(st, "deflate_plan")
    return {
        "btype": btype, "body_off": body_off, "chunk1_off": chunk1_off,
        "total_bits": int(total_bits[0]), "lit_len": lit_len,
        "lit_code": lit_code, "dist_len": dist_len, "dist_code": dist_code,
        "header": header,
    }


def bzip2_encode(data, level: int = 9) -> bytes:
    a = _u8(data)
    cap = a.size + (a.size >> 2) + 4096
    out = np.zeros(cap, dtype=np.uint8)
    n = ctypes.c_size_t(cap)
    st = lib().tpz_bzip2_encode(_u8ptr(a), a.size, level,
                                _ptr(out, ctypes.c_uint8), ctypes.byref(n))
    raise_for_status(st, "bzip2_encode")
    return out[: n.value].tobytes()


def bzip2_decode(data, max_out: int | None = None) -> bytes:
    a = _u8(data)
    cap = max_out if max_out is not None else max(4096, 80 * a.size)
    for _ in range(8):
        out = np.zeros(cap, dtype=np.uint8)
        n = ctypes.c_size_t(cap)
        st = lib().tpz_bzip2_decode(_u8ptr(a), a.size,
                                    _ptr(out, ctypes.c_uint8), ctypes.byref(n))
        if st == STATUS_BUFFER_TOO_SMALL and max_out is None:
            cap = n.value
            continue
        raise_for_status(st, "bzip2_decode")
        return out[: n.value].tobytes()
    raise_for_status(STATUS_BUFFER_TOO_SMALL, "bzip2_decode: output cap")


def bzip2_rle1(data, level: int = 9):
    """Host RLE1 + block split. Returns (rle_bytes, block_off, block_len,
    block_crc) with int64 offsets/lengths into rle_bytes."""
    a = _u8(data)
    cap = 2 * a.size + 4096
    rle = np.zeros(cap, dtype=np.uint8)
    rle_len = ctypes.c_size_t(cap)
    cap_blocks = max(4, 2 + a.size // 100000)
    off = np.zeros(cap_blocks, dtype=np.int64)
    ln = np.zeros(cap_blocks, dtype=np.int64)
    crc = np.zeros(cap_blocks, dtype=np.uint32)
    nb = ctypes.c_int32(cap_blocks)
    st = lib().tpz_bzip2_rle1(
        _u8ptr(a), a.size, level, _ptr(rle, ctypes.c_uint8),
        ctypes.byref(rle_len), _ptr(off, ctypes.c_int64),
        _ptr(ln, ctypes.c_int64), _ptr(crc, ctypes.c_uint32),
        ctypes.byref(nb))
    raise_for_status(st, "bzip2_rle1")
    k = nb.value
    return rle[: rle_len.value], off[:k], ln[:k], crc[:k]


def bzip2_assemble(bwt_last: np.ndarray, block_off, block_len, block_crc,
                   orig_ptrs, level: int = 9) -> bytes:
    last = np.ascontiguousarray(bwt_last, dtype=np.uint8)
    off = np.ascontiguousarray(block_off, dtype=np.int64)
    ln = np.ascontiguousarray(block_len, dtype=np.int64)
    crc = np.ascontiguousarray(block_crc, dtype=np.uint32)
    orig = np.ascontiguousarray(orig_ptrs, dtype=np.uint32)
    nb = off.size
    cap = int(ln.sum()) + 4096 + 64 * nb
    out = np.zeros(cap, dtype=np.uint8)
    n = ctypes.c_size_t(cap)
    st = lib().tpz_bzip2_assemble(
        _u8ptr(last), _ptr(off, ctypes.c_int64), _ptr(ln, ctypes.c_int64),
        _ptr(crc, ctypes.c_uint32), _ptr(orig, ctypes.c_uint32), nb, level,
        _ptr(out, ctypes.c_uint8), ctypes.byref(n))
    raise_for_status(st, "bzip2_assemble")
    return out[: n.value].tobytes()


def bzip2_assemble_mtf(mtfv: np.ndarray, sym_off, sym_len, used,
                       block_crc, orig_ptrs, level: int = 9) -> bytes:
    """Assemble a bzip2 stream from device-produced MTF+RLE2 symbol
    streams (cpp/bzip2.cc Bzip2AssembleMtf; the multi-table Huffman coder
    is shared bit-for-bit with the all-host path)."""
    mv = np.ascontiguousarray(mtfv, dtype=np.uint16)
    off = np.ascontiguousarray(sym_off, dtype=np.int64)
    ln = np.ascontiguousarray(sym_len, dtype=np.int32)
    us = np.ascontiguousarray(used, dtype=np.uint8)
    crc = np.ascontiguousarray(block_crc, dtype=np.uint32)
    orig = np.ascontiguousarray(orig_ptrs, dtype=np.uint32)
    nb = off.size
    cap = int(ln.sum()) * 2 + 4096 + 64 * nb
    out = np.zeros(cap, dtype=np.uint8)
    n = ctypes.c_size_t(cap)
    st = lib().tpz_bzip2_assemble_mtf(
        _ptr(mv, ctypes.c_uint16), _ptr(off, ctypes.c_int64),
        _ptr(ln, ctypes.c_int32), _ptr(us, ctypes.c_uint8),
        _ptr(crc, ctypes.c_uint32), _ptr(orig, ctypes.c_uint32), nb, level,
        _ptr(out, ctypes.c_uint8), ctypes.byref(n))
    raise_for_status(st, "bzip2_assemble_mtf")
    return out[: n.value].tobytes()


def bwt_ref(data) -> tuple[np.ndarray, int]:
    """Reference rotation-sort BWT: returns (last_column, origin_ptr)."""
    a = _u8(data)
    out = np.zeros(max(1, a.size), dtype=np.uint8)
    orig = lib().tpz_bwt_ref(_u8ptr(a), a.size, _ptr(out, ctypes.c_uint8))
    return out[: a.size], int(orig)


def bwt_ref_doubling(data) -> tuple[np.ndarray, int]:
    """Prefix-doubling rotation sort — the algorithm-independent twin for
    differentially testing BwtEncode's SA-IS fast path."""
    a = _u8(data)
    out = np.zeros(max(1, a.size), dtype=np.uint8)
    L = lib()
    fn = L.tpz_bwt_ref_doubling
    fn.restype = ctypes.c_uint32
    fn.argtypes = L.tpz_bwt_ref.argtypes
    orig = fn(_u8ptr(a), a.size, _ptr(out, ctypes.c_uint8))
    return out[: a.size], int(orig)


def bzip2_scan_to_last(data):
    """Stage 1 of device decode: per-block pre-iBWT last columns.
    Returns (blob, offs, lens, origs, crcs) or None when the stream shape
    isn't supported (caller falls back to bzip2_decode)."""
    from tpz.errors import STATUS_UNEXPECTED

    a = _u8(data)
    cap_blocks = max(4, a.size // 100 + 8)
    blob_cap = 16 * a.size + (1 << 16)  # worst-case bzip2 expansion
    blob = np.zeros(blob_cap, np.uint8)
    offs = np.zeros(cap_blocks, np.int64)
    lens = np.zeros(cap_blocks, np.int64)
    origs = np.zeros(cap_blocks, np.uint32)
    crcs = np.zeros(cap_blocks, np.uint32)
    nb = ctypes.c_int32(cap_blocks)
    st = lib().tpz_bzip2_scan_to_last(
        _u8ptr(a), a.size, _ptr(blob, ctypes.c_uint8), blob_cap,
        _ptr(offs, ctypes.c_int64), _ptr(lens, ctypes.c_int64),
        _ptr(origs, ctypes.c_uint32), _ptr(crcs, ctypes.c_uint32),
        ctypes.byref(nb))
    if st == STATUS_UNEXPECTED:
        return None
    raise_for_status(st, "bzip2_scan_to_last")
    n = nb.value
    return blob, offs[:n], lens[:n], origs[:n], crcs[:n]


def bzip2_rle1_inverse(bwt_blob: np.ndarray, offs, lens, crcs) -> bytes:
    nb = len(offs)
    a = np.ascontiguousarray(bwt_blob, np.uint8)
    o = np.ascontiguousarray(offs, np.int64)
    l = np.ascontiguousarray(lens, np.int64)
    c = np.ascontiguousarray(crcs, np.uint32)
    cap = int(255 * np.sum(lens) // 4 + 4096)
    out = np.zeros(cap, np.uint8)
    n = ctypes.c_size_t(cap)
    st = lib().tpz_bzip2_rle1_inverse(
        _u8ptr(a), _ptr(o, ctypes.c_int64), _ptr(l, ctypes.c_int64),
        _ptr(c, ctypes.c_uint32), nb, _ptr(out, ctypes.c_uint8),
        ctypes.byref(n))
    raise_for_status(st, "bzip2_rle1_inverse")
    return out[: n.value].tobytes()


def lzhuf_encode(data, dict_bits: int = 13, max_chain: int = 16) -> bytes:
    """Raw LHA lh4-lh7 stream (no size header; LHA archives carry the
    original size externally, as does our container)."""
    a = _u8(data)
    cap = a.size + (a.size >> 2) + 4096
    out = np.zeros(cap, dtype=np.uint8)
    n = ctypes.c_size_t(cap)
    st = lib().tpz_lzhuf_encode(_u8ptr(a), a.size, dict_bits, max_chain,
                                _ptr(out, ctypes.c_uint8), ctypes.byref(n))
    raise_for_status(st, "lzhuf_encode")
    return out[: n.value].tobytes()


def lzhuf_encode_tokens(tokens: np.ndarray, dict_bits: int = 13) -> bytes:
    toks = np.ascontiguousarray(tokens, dtype=np.int32)
    ntok = toks.shape[0] if toks.ndim == 2 else 0
    cap = 4 * max(ntok, 16) + 4096
    out = np.zeros(cap, dtype=np.uint8)
    n = ctypes.c_size_t(cap)
    st = lib().tpz_lzhuf_encode_tokens(
        _ptr(toks, ctypes.c_int32) if ntok else _ptr(
            np.zeros((1, 4), np.int32), ctypes.c_int32),
        ntok, dict_bits, _ptr(out, ctypes.c_uint8), ctypes.byref(n))
    raise_for_status(st, "lzhuf_encode_tokens")
    return out[: n.value].tobytes()


def lzhuf_decode(data, orig_size: int, dict_bits: int = 13) -> bytes:
    a = _u8(data)
    cap = orig_size + 16
    out = np.zeros(cap, dtype=np.uint8)
    n = ctypes.c_size_t(cap)
    st = lib().tpz_lzhuf_decode(_u8ptr(a), a.size, dict_bits, orig_size,
                                _ptr(out, ctypes.c_uint8), ctypes.byref(n))
    raise_for_status(st, "lzhuf_decode")
    return out[: n.value].tobytes()


def lzhuf_index(data, orig_size: int, dict_bits: int,
                seg_out: int = 1 << 16):
    """Token-aligned segment index over an lzhuf body (cpp LzhufIndex)
    for the device decode walk. Returns a dict or None when declined."""
    a = _u8(data)
    max_segs = max(8, 2 * (orig_size // seg_out) + 16)
    max_blocks = max(8, orig_size // 4096 + 16)
    sb = np.zeros(max_segs, np.int64)
    eb = np.zeros(max_segs, np.int64)
    ol = np.zeros(max_segs, np.int64)
    cl = np.zeros(max_segs, np.int32)
    cd = np.zeros(max_segs, np.int32)
    bid = np.zeros(max_segs, np.int32)
    clens = np.zeros((max_blocks, 510), np.uint8)
    plens = np.zeros((max_blocks, 20), np.uint8)
    ccon = np.zeros(max_blocks, np.int32)
    pcon = np.zeros(max_blocks, np.int32)
    nseg = np.zeros(1, np.int64)
    nblk = np.zeros(1, np.int64)
    st = lib().tpz_lzhuf_index(
        _u8ptr(a), a.size, dict_bits, orig_size, seg_out, max_segs,
        max_blocks, _ptr(sb, ctypes.c_int64), _ptr(eb, ctypes.c_int64),
        _ptr(ol, ctypes.c_int64), _ptr(cl, ctypes.c_int32),
        _ptr(cd, ctypes.c_int32), _ptr(bid, ctypes.c_int32),
        _ptr(clens, ctypes.c_uint8), _ptr(plens, ctypes.c_uint8),
        _ptr(ccon, ctypes.c_int32), _ptr(pcon, ctypes.c_int32),
        _ptr(nseg, ctypes.c_int64), _ptr(nblk, ctypes.c_int64))
    if st != 0:
        return None
    ks, kb = int(nseg[0]), int(nblk[0])
    return {"seg_bits": sb[:ks], "end_bits": eb[:ks], "out_lens": ol[:ks],
            "carry_len": cl[:ks], "carry_dist": cd[:ks],
            "block_ids": bid[:ks], "c_lens": clens[:kb],
            "p_lens": plens[:kb], "c_consts": ccon[:kb],
            "p_consts": pcon[:kb]}


def lzhuf_plan(c_freq: np.ndarray, p_freq: np.ndarray,
               token_counts: np.ndarray, dict_bits: int) -> dict:
    """Host planning for the device lzhuf pipeline (cpp LzhufPlan).

    c_freq [NB, 510] uint32, p_freq [NB, np] uint32 (padded rows fine),
    token_counts [NB] uint32. p tables come back strided [NB, 20]."""
    cf = np.ascontiguousarray(c_freq, dtype=np.uint32)
    nb = cf.shape[0]
    npad = np.zeros((nb, 20), dtype=np.uint32)
    npad[:, : p_freq.shape[1]] = p_freq
    # LzhufPlan reads p_freq rows with stride m.np — rebuild tight rows.
    from tpz.constants import LZHUF_METHODS

    np_ = next(v[1] for v in LZHUF_METHODS.values() if v[0] == dict_bits)
    pf = np.ascontiguousarray(npad[:, :np_], dtype=np.uint32)
    tc = np.ascontiguousarray(token_counts, dtype=np.uint32)
    body_off = np.zeros(nb, dtype=np.int64)
    total_bits = np.zeros(1, dtype=np.int64)
    c_len = np.zeros((nb, 510), dtype=np.uint8)
    c_code = np.zeros((nb, 510), dtype=np.uint16)
    p_len = np.zeros((nb, 20), dtype=np.uint8)
    p_code = np.zeros((nb, 20), dtype=np.uint16)
    cap = int(tc.sum()) * 8 + 512 * nb + 1024
    header = np.zeros(cap, dtype=np.uint8)
    st = lib().tpz_lzhuf_plan(
        _ptr(cf, ctypes.c_uint32), _ptr(pf, ctypes.c_uint32),
        _ptr(tc, ctypes.c_uint32), nb, dict_bits,
        _ptr(body_off, ctypes.c_int64), _ptr(total_bits, ctypes.c_int64),
        _ptr(c_len, ctypes.c_uint8), _ptr(c_code, ctypes.c_uint16),
        _ptr(p_len, ctypes.c_uint8), _ptr(p_code, ctypes.c_uint16),
        _ptr(header, ctypes.c_uint8), cap)
    raise_for_status(st, "lzhuf_plan")
    return {
        "body_off": body_off, "total_bits": int(total_bits[0]),
        "c_len": c_len, "c_code": c_code, "p_len": p_len, "p_code": p_code,
        "header": header,
    }


class InflateStream:
    """Resumable raw-DEFLATE decoder (cpp InflateStream): feed input
    increments, collect decoded bytes as they become available. O(total)
    across many small feeds — the streaming decode facade's engine."""

    def __init__(self) -> None:
        self._h = lib().tpz_inflate_stream_new()
        self.finished = False
        self.consumed = 0  # input bytes spanned once finished

    def feed(self, data: bytes) -> bytes:
        """Feed compressed bytes; returns newly decoded plaintext.
        Raises DataError via raise_for_status on corrupt input."""
        if self._h is None:
            raise RuntimeError("inflate stream closed")
        a = _u8(data)
        fin = ctypes.c_int32(0)
        consumed = ctypes.c_int64(0)
        pending = ctypes.c_int64(0)
        st = lib().tpz_inflate_stream_feed(
            self._h, _u8ptr(a), a.size, ctypes.byref(fin),
            ctypes.byref(consumed), ctypes.byref(pending))
        raise_for_status(st, "inflate_stream")
        self.finished = bool(fin.value)
        self.consumed = int(consumed.value)
        n = int(pending.value)
        if n == 0:
            return b""
        out = np.empty(n, dtype=np.uint8)
        got = lib().tpz_inflate_stream_take(
            self._h, _ptr(out, ctypes.c_uint8), n)
        return out[:got].tobytes()

    def close(self) -> None:
        if self._h is not None:
            lib().tpz_inflate_stream_free(self._h)
            self._h = None

    def __del__(self):  # pragma: no cover - GC timing
        try:
            self.close()
        except Exception:
            pass


class LzhufStream:
    """Resumable lh4-lh7 decoder (cpp LzhufStream): feed compressed
    increments, collect plaintext as blocks/tokens complete. O(total)
    across many small feeds (VERDICT r4 next item 9 — the crate's
    iterator adapters are O(total); the old facade re-parsed the whole
    buffer per write)."""

    def __init__(self, dict_bits: int, orig_size: int) -> None:
        self._h = lib().tpz_lzhuf_stream_new(dict_bits, orig_size)
        self.finished = orig_size == 0

    def feed(self, data: bytes) -> bytes:
        if self._h is None:
            raise RuntimeError("lzhuf stream closed")
        a = _u8(data)
        fin = ctypes.c_int32(0)
        pending = ctypes.c_int64(0)
        st = lib().tpz_lzhuf_stream_feed(
            self._h, _u8ptr(a), a.size, ctypes.byref(fin),
            ctypes.byref(pending))
        raise_for_status(st, "lzhuf_stream")
        self.finished = bool(fin.value)
        n = int(pending.value)
        if n == 0:
            return b""
        out = np.empty(n, dtype=np.uint8)
        got = lib().tpz_lzhuf_stream_take(
            self._h, _ptr(out, ctypes.c_uint8), n)
        return out[:got].tobytes()

    def close(self) -> None:
        if self._h is not None:
            lib().tpz_lzhuf_stream_free(self._h)
            self._h = None

    def __del__(self):  # pragma: no cover - GC timing
        try:
            self.close()
        except Exception:
            pass


def inflate(data, max_out: int | None = None) -> tuple[bytes, int]:
    """Raw-DEFLATE decode. Returns (plaintext, consumed_input_bytes)."""
    a = _u8(data)
    cap = max_out if max_out is not None else max(1024, 64 * a.size + 1024)
    for _ in range(8):
        out = np.zeros(cap, dtype=np.uint8)
        n = ctypes.c_size_t(cap)
        consumed = ctypes.c_size_t(0)
        st = lib().tpz_inflate(
            _u8ptr(a), a.size, _ptr(out, ctypes.c_uint8), ctypes.byref(n),
            ctypes.byref(consumed))
        if st == STATUS_BUFFER_TOO_SMALL and max_out is None:
            cap = n.value
            continue
        raise_for_status(st, "inflate")
        return out[: n.value].tobytes(), consumed.value
    raise_for_status(STATUS_BUFFER_TOO_SMALL, "inflate: output cap")

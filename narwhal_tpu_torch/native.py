"""ctypes loader for the native (C++) host components.

Port of `narwhal_tpu/native.py` (the JAX package's counterpart), over the
port's own copies of the sources in `native_src/`: `storage_engine.cpp` (the
WAL-backed column-family engine behind `storage.StorageEngine`) and
`scalar_ops.cpp` (the verifier's batched precheck, SHA-512 challenge and
mod-L folds). Each is built with g++ on first use into `native_src/_build/`
under a name that hashes the source and the flags, so an edited source
rebuilds and an unchanged one is reused. A build writes a temporary file
and renames it into place, so processes that build at once (test workers)
never load a half-written library.

Loading is best-effort, as in the reference: when the toolchain or the
library is unavailable `load()` / `load_scalar()` return None and the callers
use the pure-Python twins. NARWHAL_NATIVE=0 disables both.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading

logger = logging.getLogger("narwhal.native")

SRC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "native_src")
BUILD_DIR = os.path.join(SRC_DIR, "_build")
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_LOCK = threading.Lock()
_lib: ctypes.CDLL | None = None
_tried = False
_scalar: ctypes.CDLL | None = None
_scalar_tried = False


def _target(stem: str, libs: tuple[str, ...]) -> str:
    with open(os.path.join(SRC_DIR, f"{stem}.cpp"), "rb") as f:
        h = hashlib.sha256(f.read())
    h.update(" ".join(CXX_FLAGS + libs).encode())
    return os.path.join(BUILD_DIR, f"lib{stem}-{h.hexdigest()[:16]}.so")


def _build_lib(stem: str, libs: tuple[str, ...] = ()) -> str | None:
    """The path of `stem`'s built library (built here if missing), or None
    when g++ is absent or fails."""
    out = _target(stem, libs)
    if os.path.exists(out):
        return out
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    try:
        os.makedirs(BUILD_DIR, exist_ok=True)
        subprocess.run(
            ["g++", *CXX_FLAGS, "-o", tmp, os.path.join(SRC_DIR, f"{stem}.cpp"), *libs],
            check=True, capture_output=True,
        )
        os.replace(tmp, out)
    except (OSError, subprocess.CalledProcessError) as e:
        detail = getattr(e, "stderr", b"") or b""
        logger.warning("native build of %s.cpp failed: %s %s", stem, e,
                       detail.decode(errors="replace")[-2000:])
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return None
    return out


def load() -> ctypes.CDLL | None:
    """The storage engine's shared library, built on demand; None if
    unavailable or NARWHAL_NATIVE=0."""
    global _lib, _tried
    with _LOCK:
        if _tried:
            return _lib
        _tried = True
        if os.environ.get("NARWHAL_NATIVE", "1") == "0":
            return None
        path = _build_lib("storage_engine", ("-lz",))
        if path is None:
            return None
        try:
            lib = ctypes.CDLL(path)
        except OSError as e:
            logger.warning("native storage engine load failed: %s", e)
            return None
        lib.nse_open.restype = ctypes.c_void_p
        lib.nse_open.argtypes = [ctypes.c_char_p]
        lib.nse_write_batch.restype = ctypes.c_int
        lib.nse_write_batch.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint32]
        lib.nse_get.restype = ctypes.c_int
        lib.nse_get.argtypes = [
            ctypes.c_void_p,
            ctypes.c_char_p,
            ctypes.c_char_p,
            ctypes.c_uint32,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_ubyte)),
            ctypes.POINTER(ctypes.c_uint32),
        ]
        lib.nse_contains.restype = ctypes.c_int
        lib.nse_contains.argtypes = [
            ctypes.c_void_p,
            ctypes.c_char_p,
            ctypes.c_char_p,
            ctypes.c_uint32,
        ]
        lib.nse_len.restype = ctypes.c_uint64
        lib.nse_len.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.nse_dump.restype = None
        lib.nse_dump.argtypes = [
            ctypes.c_void_p,
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_ubyte)),
            ctypes.POINTER(ctypes.c_uint64),
        ]
        lib.nse_compact.restype = None
        lib.nse_compact.argtypes = [ctypes.c_void_p]
        lib.nse_close_log.restype = None
        lib.nse_close_log.argtypes = [ctypes.c_void_p]
        lib.nse_close.restype = None
        lib.nse_close.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def load_scalar() -> ctypes.CDLL | None:
    """The ed25519 host scalar pipeline (native_src/scalar_ops.cpp), built on
    demand; None when the toolchain is unavailable or NARWHAL_NATIVE=0.
    ctypes releases the GIL for the call, so batched hashing and mod-L
    arithmetic overlap the card's work in the verify pipeline."""
    global _scalar, _scalar_tried
    with _LOCK:
        if _scalar_tried:
            return _scalar
        _scalar_tried = True
        if os.environ.get("NARWHAL_NATIVE", "1") == "0":
            return None
        path = _build_lib("scalar_ops")
        if path is None:
            return None
        try:
            lib = ctypes.CDLL(path)
        except OSError as e:
            logger.warning("native scalar pipeline load failed: %s", e)
            return None
        lib.ed25519_precheck_k.restype = ctypes.c_int
        lib.ed25519_precheck_k.argtypes = [
            ctypes.c_int64,
            ctypes.c_char_p,  # pk rows
            ctypes.c_char_p,  # sig rows
            ctypes.c_char_p,  # msg buffer
            ctypes.c_void_p,  # int64 offsets
            ctypes.c_void_p,  # out k rows
            ctypes.c_void_p,  # out ok bytes
        ]
        lib.scalar_fold.restype = None
        lib.scalar_fold.argtypes = [
            ctypes.c_int64,
            ctypes.c_void_p,  # k rows
            ctypes.c_void_p,  # s rows
            ctypes.c_char_p,  # z rows
            ctypes.c_void_p,  # out ak rows
            ctypes.c_void_p,  # out sum
        ]
        lib.scalar_mulmod.restype = None
        lib.scalar_mulmod.argtypes = [
            ctypes.c_int64,
            ctypes.c_void_p,  # a rows (32B)
            ctypes.c_void_p,  # b rows (32B)
            ctypes.c_void_p,  # out rows (32B)
        ]
        _scalar = lib
        return _scalar


class NativeEngine:
    """Handle on one C++ engine instance (tables + WAL)."""

    def __init__(self, path: str | None):
        lib = load()
        if lib is None:
            raise RuntimeError("native storage engine unavailable")
        self._lib = lib
        self._h = lib.nse_open((path or "").encode())
        if not self._h:
            raise RuntimeError(f"nse_open failed for {path!r}")

    def write_batch(self, body: bytes) -> None:
        if self._lib.nse_write_batch(self._h, body, len(body)) != 0:
            raise RuntimeError("malformed write batch")

    def get(self, cf: bytes, key: bytes) -> bytes | None:
        val = ctypes.POINTER(ctypes.c_ubyte)()
        vlen = ctypes.c_uint32()
        hit = self._lib.nse_get(
            self._h, cf, key, len(key), ctypes.byref(val), ctypes.byref(vlen)
        )
        if not hit:
            return None
        return ctypes.string_at(val, vlen.value)

    def contains(self, cf: bytes, key: bytes) -> bool:
        return bool(self._lib.nse_contains(self._h, cf, key, len(key)))

    def len(self, cf: bytes) -> int:
        return int(self._lib.nse_len(self._h, cf))

    def items(self, cf: bytes) -> list[tuple[bytes, bytes]]:
        buf = ctypes.POINTER(ctypes.c_ubyte)()
        blen = ctypes.c_uint64()
        self._lib.nse_dump(self._h, cf, ctypes.byref(buf), ctypes.byref(blen))
        raw = ctypes.string_at(buf, blen.value) if blen.value else b""
        out = []
        pos = 0
        while pos < len(raw):
            klen = int.from_bytes(raw[pos : pos + 4], "little")
            pos += 4
            key = raw[pos : pos + klen]
            pos += klen
            vlen = int.from_bytes(raw[pos : pos + 4], "little")
            pos += 4
            out.append((key, raw[pos : pos + vlen]))
            pos += vlen
        return out

    def compact(self) -> None:
        self._lib.nse_compact(self._h)

    def close(self) -> None:
        """Stop appends; tables stay readable (Python-engine close parity:
        late reads during shutdown must not hit a freed handle)."""
        if self._h:
            self._lib.nse_close_log(self._h)

    def __del__(self) -> None:
        h, self._h = getattr(self, "_h", None), None
        if h:
            try:
                self._lib.nse_close(h)
            except Exception:
                pass

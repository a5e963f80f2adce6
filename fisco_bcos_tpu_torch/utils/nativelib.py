"""Native-library source-hash verification.

The prebuilt ``native/build/lib*.so`` binaries are committed and
auto-loaded; nothing else guarantees they match the checked-in C++
sources. Since nevm/ncrypto carry consensus-critical semantics, a stale
binary would silently change behavior that the tests then validate
against itself. Each library therefore exports ``<name>_src_hash()``
(sha256 of its source, stamped by native/Makefile); loaders call
:func:`check_src_hash` and refuse a drifted binary unless
``FBTPU_NATIVE_ALLOW_STALE=1``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os

_ALLOW_STALE = "FBTPU_NATIVE_ALLOW_STALE"


def check_src_hash(lib: ctypes.CDLL, name: str, src_path: str) -> bool:
    """True if ``lib`` was built from the bytes currently at ``src_path``.

    On mismatch (or an unstamped/old binary) returns False after printing
    a loud warning — callers treat that as library-unavailable so the
    pure-Python path runs instead — unless FBTPU_NATIVE_ALLOW_STALE=1.
    """
    try:
        fn = getattr(lib, f"{name}_src_hash")
    except AttributeError:
        built = "unstamped"
    else:
        fn.restype = ctypes.c_char_p
        built = (fn() or b"").decode()
    try:
        with open(src_path, "rb") as f:
            want = hashlib.sha256(f.read()).hexdigest()
    except OSError:
        return True  # source not shipped (binary-only install): trust
    if built == want:
        return True
    import sys
    print(f"[nativelib] {name}: binary/source hash mismatch "
          f"(built={built[:16]}.. source={want[:16]}..) — "
          f"{'ALLOWING (env override)' if os.environ.get(_ALLOW_STALE) == '1' else 'refusing stale binary, rebuild with `make -C native`'}",
          file=sys.stderr, flush=True)
    return os.environ.get(_ALLOW_STALE) == "1"


# -- the port's addition: rebuild a library that will not load ------------
# The JAX package loads the prebuilt native/build/lib*.so or falls back to
# the pure-Python oracle. The port loads the same prebuilt file, and where
# it fails CDLL (another host's glibc or libstdc++) or is stale against its
# source, builds it from native/<name>/<name>.cpp into the package's own
# git-ignored _build/native/ with native/Makefile's flags and source-hash
# stamp. Nothing is ever written under native/.
_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
NATIVE_DIR = os.path.join(_REPO, "native")
BUILD_DIR = os.path.join(_REPO, "fisco_bcos_tpu_torch", "_build", "native")
# native/Makefile: CXXFLAGS, plus -O3 for ncrypto (later flags win)
_CXXFLAGS = ("-O2", "-std=c++20", "-fPIC", "-Wall", "-Wextra")
_EXTRA = {"ncrypto": ("-O3",)}


def source_path(name: str) -> str:
    return os.path.join(NATIVE_DIR, name, f"{name}.cpp")


def build_library(name: str) -> str | None:
    """Build lib<name>.so from its checked-in source into BUILD_DIR (once:
    a stamped build of the current source is reused) -> its path, or None
    when there is no source or no compiler."""
    import shutil
    import subprocess
    import sys

    src = source_path(name)
    out = os.path.join(BUILD_DIR, f"lib{name}.so")
    try:
        with open(src, "rb") as f:
            want = hashlib.sha256(f.read()).hexdigest()
    except OSError:
        return None
    if os.path.exists(out):
        try:
            if _stamp(ctypes.CDLL(out), name) == want:
                return out
        except OSError:
            pass
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"  # concurrent builders each rename whole files
    cmd = [cxx, *_CXXFLAGS, *_EXTRA.get(name, ()), f'-DFBTPU_SRC_HASH="{want}"',
           "-shared", "-o", tmp, src]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        print(f"[nativelib] {name}: build failed: {proc.stderr[-2000:]}",
              file=sys.stderr, flush=True)
        return None
    os.replace(tmp, out)
    print(f"[nativelib] {name}: built {out} from {src}", file=sys.stderr, flush=True)
    return out


def _stamp(lib: ctypes.CDLL, name: str) -> str:
    try:
        fn = getattr(lib, f"{name}_src_hash")
    except AttributeError:
        return "unstamped"
    fn.restype = ctypes.c_char_p
    return (fn() or b"").decode()


def open_library(name: str, path: str) -> ctypes.CDLL | None:
    """CDLL of `path` when it loads and passes check_src_hash against
    native/<name>/<name>.cpp; else the library built from that source
    (build_library); else None (the caller falls back to the oracle)."""
    try:
        lib = ctypes.CDLL(path)
        if check_src_hash(lib, name, source_path(name)):
            return lib
    except OSError as exc:
        import sys
        print(f"[nativelib] {name}: {path} does not load ({exc}); building it "
              f"from source", file=sys.stderr, flush=True)
    built = build_library(name)
    if built is None:
        return None
    lib = ctypes.CDLL(built)
    return lib if check_src_hash(lib, name, source_path(name)) else None

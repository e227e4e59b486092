"""Persistent content-addressed cache of the port's compiled kernels.

The port runs no XLA programs: its only compiled artifacts are the nvcc
libraries that ``ops/_build.py`` builds, ``build/<name>-<hash>.so``, one a
CUDA source.  A replica pays their compile leg at the first launch of
each (a paged replica's first decode, a trainer's first step), and every
replica on the same card type pays the same nvcc run for the same bytes.
This cache stores each library once, keyed by content —
``sha256(source digest + topology fingerprint)``, where the digest is
``_build``'s (the source, the shared headers and the flags) — so a hit is
correct by construction: any input that would build differently hashes
differently.  It is the counterpart of the JAX package's cache of
serialized XLA executables, with the same interface and counters.

Storage is a flat content-addressed directory
(``<root>/<k[:2]>/<k>.so``), written atomically (tmp + ``os.replace``)
so a crashed writer never publishes a torn entry.  A miss can also be
filled over HTTP from peer replicas (``GET /elastic/compile/<key>`` on the
serving server) before falling back to nvcc; what a peer returns is
persisted locally so the fleet converges to everyone having everything.

:meth:`CompileCache.ensure` makes one library present in ``build/``,
trying in order: the library already there, the root, each peer, and
nvcc (whose library it then stores into the root).  ``misses`` counts
nvcc runs and nothing else: a start with ``compile_cache_misses == 0``
ran no nvcc.  The counters describe libraries resolved, not libraries
bound: ``_build`` binds each library once per process.

Trust: loading a library runs its code (its initialisers when it is
loaded, its kernels when they launch), as the JAX package's cache runs
``pickle.loads`` on a peer's bytes.  The peers are the operator's own
replicas.  A fetched file is installed only if it starts with the ELF
magic, only under the ``library_path`` name of the local sources, and
only after ``ctypes`` loaded it and found its entry point; one that fails
counts in ``errors`` and the library is built by nvcc instead — still
the kernel, never its plain version.

Env knobs (read by :meth:`CompileCache.from_env`):

``DSTACK_COMPILE_CACHE``
    cache root directory; unset → caching disabled
``DSTACK_COMPILE_CACHE_PEERS``
    comma-separated peer base URLs to try on local miss
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import re
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Callable, Dict, Iterable, Optional, Sequence

from dstack_tpu_torch.ops import _build

logger = logging.getLogger(__name__)

__all__ = [
    "CachedKernels",
    "CompileCache",
    "cache_key",
    "maybe_cached",
    "topology_fingerprint",
]

ENV_CACHE_DIR = "DSTACK_COMPILE_CACHE"
ENV_CACHE_PEERS = "DSTACK_COMPILE_CACHE_PEERS"

#: entry file suffix — a shared library, as nvcc wrote it
ENTRY_SUFFIX = ".so"
ELF_MAGIC = b"\x7fELF"

_FETCH_TIMEOUT_S = 10.0


def _card() -> str:
    try:
        import torch

        if torch.cuda.is_available():
            major, minor = torch.cuda.get_device_capability(0)
            return f"sm_{major}{minor}/{torch.cuda.get_device_name(0)}"
    except (ImportError, RuntimeError):
        pass
    return "sm_none/no-card"


def _nvcc_version() -> str:
    try:
        out = subprocess.run([_build.nvcc(), "--version"],
                             capture_output=True, text=True,
                             timeout=60).stdout
    except (RuntimeError, OSError, subprocess.SubprocessError):
        return "nvcc-none"
    found = re.search(r"V(\d+\.\d+\.\d+)", out)
    return "nvcc-" + (found.group(1) if found else out.strip()[-40:])


def _driver_version() -> str:
    try:
        version = ctypes.c_int()
        rc = ctypes.CDLL("libcuda.so.1").cuDriverGetVersion(
            ctypes.byref(version))
    except (OSError, AttributeError):
        return "driver-none"
    return f"driver-{version.value}" if rc == 0 else "driver-none"


def topology_fingerprint() -> str:
    """What must match for a cached library to be loadable and right: the
    card's compute capability and name (the SASS nvcc wrote is for one
    architecture), nvcc's version (another compiler writes other code)
    and the driver's CUDA version (which must load it).  On a host
    without a card, nvcc or a driver the parts read ``sm_none/no-card``,
    ``nvcc-none`` and ``driver-none``.

    The JAX package's fingerprint also names the device and process
    counts, which change an XLA program; they are left out here because a
    ``.so`` is the same file for one card or eight, one process or many.
    """
    return f"cuda/{_card()}/{_nvcc_version()}/{_driver_version()}"


def cache_key(source_digest: str, topology: Optional[str] = None) -> str:
    """Content address of one library's sources on one topology."""
    topo = topology_fingerprint() if topology is None else topology
    h = hashlib.sha256()
    h.update(source_digest.encode("utf-8"))
    h.update(b"\x00")
    h.update(topo.encode("utf-8"))
    return h.hexdigest()


def _default_fetch(url: str, timeout: float = _FETCH_TIMEOUT_S) -> bytes:
    import urllib.request

    with urllib.request.urlopen(url, timeout=timeout) as resp:  # noqa: S310
        return resp.read()


def load_check(path: str, name: str) -> None:
    """Raise unless ``path`` loads with ``ctypes`` and has the entry point
    of ``csrc/<name>.cu``."""
    getattr(ctypes.CDLL(path), _build.SIGNATURES[name][0])


class CompileCache:
    """Content-addressed store of the kernels' libraries, local + peer.

    Thread-safe; counters (``hits``/``misses``/``peer_hits``/``puts``/
    ``errors``) surface on ``/load`` and ``/stats`` via :meth:`snapshot`.
    ``hits``: libraries resolved without nvcc (already in ``build/``, from
    the root or from a peer); ``misses``: nvcc runs; ``peer_hits``:
    libraries fetched from a peer; ``puts``: entries written into the
    root; ``errors``: unreadable or unloadable entries and failed writes.

    ``loader(path, name)`` raises when the file at ``path`` is not a
    loadable library of ``name`` (default :func:`load_check`).
    """

    def __init__(self, root: Optional[os.PathLike] = None,
                 peers: Sequence[str] = (),
                 fetch: Optional[Callable[[str], bytes]] = None,
                 loader: Callable[[str, str], None] = load_check) -> None:
        self.root = Path(root) if root else None
        self.peers = [p.rstrip("/") for p in peers if p]
        self._fetch = fetch or _default_fetch
        self._loader = loader
        self._lock = threading.Lock()
        self._ensure_lock = threading.Lock()
        self._topology: Optional[str] = None
        self.hits = 0
        self.misses = 0
        self.peer_hits = 0
        self.puts = 0
        self.errors = 0
        #: name -> {"source", "seconds"} of each library :meth:`ensure`
        #: resolved (source: "build", "cache", "peer" or "compile")
        self.resolved: Dict[str, dict] = {}

    # -- construction -------------------------------------------------

    @classmethod
    def from_env(cls, env: Optional[Dict[str, str]] = None
                 ) -> Optional["CompileCache"]:
        """Cache per env knobs, or None when both knobs are unset."""
        env = os.environ if env is None else env
        root = env.get(ENV_CACHE_DIR, "").strip()
        peers = [p.strip() for p in
                 env.get(ENV_CACHE_PEERS, "").split(",") if p.strip()]
        if not root and not peers:
            return None
        return cls(root or None, peers)

    # -- keying/paths -------------------------------------------------

    def key_for(self, name: str) -> str:
        """Key of the library of ``csrc/<name>.cu`` on this host."""
        if self._topology is None:
            self._topology = topology_fingerprint()
        return cache_key(_build.source_digest(name), self._topology)

    def _path(self, key: str) -> Optional[Path]:
        if self.root is None:
            return None
        return self.root / key[:2] / (key + ENTRY_SUFFIX)

    def _count(self, counter: str) -> None:
        with self._lock:
            setattr(self, counter, getattr(self, counter) + 1)

    # -- byte-level store (also backs the HTTP seed path) -------------

    def get_bytes(self, key: str) -> Optional[bytes]:
        """Raw entry bytes from the local store only (seed path)."""
        path = self._path(key)
        if path is None:
            return None
        try:
            return path.read_bytes()
        except FileNotFoundError:
            return None
        except OSError:
            self._count("errors")
            return None

    def put_bytes(self, key: str, data: bytes) -> bool:
        """Atomically persist raw entry bytes (tmp + ``os.replace``)."""
        path = self._path(key)
        if path is None:
            return False
        try:
            path.parent.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(dir=str(path.parent),
                                       prefix=".tmp-", suffix=ENTRY_SUFFIX)
            try:
                with os.fdopen(fd, "wb") as f:
                    f.write(data)
                    f.flush()
                    os.fsync(f.fileno())
                os.replace(tmp, path)
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
        except OSError:
            self._count("errors")
            return False
        self._count("puts")
        return True

    def _fetch_from_peers(self, key: str,
                          accept: Optional[Callable[[bytes], bool]] = None
                          ) -> Optional[bytes]:
        """The first peer's entry for ``key`` that ``accept`` takes,
        persisted locally; None when no peer has one."""
        for peer in self.peers:
            try:
                data = self._fetch(f"{peer}/elastic/compile/{key}")
            except Exception:  # noqa: BLE001 — a down peer is a miss
                continue
            if data and (accept is None or accept(data)):
                self._count("peer_hits")
                self.put_bytes(key, data)
                return data
        return None

    # -- library-level API --------------------------------------------

    def _install(self, name: str, data: bytes) -> bool:
        """Write ``data`` into ``build/`` as the library of ``name``
        (atomically, under its ``library_path``) if it is one."""
        if not data.startswith(ELF_MAGIC):
            self._count("errors")
            return False
        path = _build.library_path(name)
        path.parent.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=ENTRY_SUFFIX, dir=path.parent)
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(data)
                f.flush()
                os.fsync(f.fileno())
            self._loader(tmp, name)
            os.replace(tmp, path)
            return True
        except (OSError, AttributeError) as e:
            logger.warning("cached library %s refused: %s", name, e)
            self._count("errors")
            return False
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)

    def _keep(self, key: str, path: Path, overwrite: bool) -> None:
        """Store the library at ``path`` into the root (when absent, or
        always with ``overwrite``)."""
        if self.root is not None and (overwrite or not self.contains(key)):
            self.put_bytes(key, path.read_bytes())

    def ensure(self, name: str,
               compiler: Optional[Callable[[Iterable[str]], object]] = None
               ) -> str:
        """Make the library of ``csrc/<name>.cu`` present in ``build/``;
        returns where it came from: "build" (already there), "cache" (the
        root), "peer" or "compile" (``compiler([name])``, by default
        ``_build.build``, which runs nvcc).  Every library found without
        nvcc is also put into the root when absent; a compiled one always
        is (it replaces an entry that failed to load)."""
        with self._ensure_lock:
            t0 = time.perf_counter()
            source = self._resolve(name, compiler or _build.build)
            self.resolved[name] = {"source": source,
                                   "seconds": time.perf_counter() - t0}
            return source

    def _resolve(self, name: str, compiler) -> str:
        key = self.key_for(name)
        path = _build.library_path(name)
        if path.exists():
            self._count("hits")
            self._keep(key, path, overwrite=False)
            return "build"
        data = self.get_bytes(key)
        if data is not None and self._install(name, data):
            self._count("hits")
            return "cache"
        if self._fetch_from_peers(
                key, accept=lambda d: self._install(name, d)) is not None:
            self._count("hits")
            return "peer"
        self._count("misses")
        compiler([name])
        self._keep(key, path, overwrite=True)
        return "compile"

    def contains(self, key: str) -> bool:
        path = self._path(key)
        return path is not None and path.exists()

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return {
                "compile_cache_hits": self.hits,
                "compile_cache_misses": self.misses,
                "compile_cache_peer_hits": self.peer_hits,
                "compile_cache_puts": self.puts,
                "compile_cache_errors": self.errors,
            }


class CachedKernels:
    """A callable whose kernels' libraries are resolved through the
    compile cache before its first call that launches them: the port's
    counterpart of the JAX package's ``CachedJit`` (which deserializes
    or compiles a jitted function's executable before its first call).

    ``kernels`` names the ``csrc/<name>.cu`` libraries ``fn`` launches;
    ``needs(*args, **kwargs)`` says whether a call launches them (a call
    on CPU tensors takes the plain versions; None: every call does).
    ``key`` is the libraries' cache keys joined by ","; ``source`` is
    "cache" when no library needed nvcc, "compile" when one did, None
    until resolved.
    """

    def __init__(self, fn: Callable, cache: CompileCache, tag: str = "",
                 kernels: Sequence[str] = (),
                 needs: Optional[Callable[..., bool]] = None) -> None:
        self._fn = fn
        self._cache = cache
        self.tag = tag
        self.kernels = tuple(kernels)
        self._needs = needs
        self.key: Optional[str] = None
        self.source: Optional[str] = None
        self._lock = threading.Lock()

    def _resolve(self) -> None:
        sources = [self._cache.ensure(name) for name in self.kernels]
        self.key = ",".join(self._cache.key_for(n) for n in self.kernels)
        self.source = "compile" if "compile" in sources else "cache"

    def __call__(self, *args, **kwargs):
        if self.source is None and (self._needs is None
                                    or self._needs(*args, **kwargs)):
            with self._lock:
                if self.source is None:
                    self._resolve()
        return self._fn(*args, **kwargs)


def maybe_cached(fn: Callable, cache: Optional[CompileCache], tag: str = "",
                 kernels: Sequence[str] = (),
                 needs: Optional[Callable[..., bool]] = None):
    """Wrap ``fn`` with the cache, or return it untouched when caching is
    disabled — the zero-risk default path."""
    if cache is None:
        return fn
    return CachedKernels(fn, cache, tag=tag, kernels=kernels, needs=needs)

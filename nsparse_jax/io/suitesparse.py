"""SuiteSparse collection access: fetch-and-cache by ``Group/Name``.

Role analog: the reference's harness exists to run SuiteSparse matrices
(``/root/reference/README.md:30-37`` passes ``.mtx`` paths to the sample
binaries).  This helper downloads a matrix from the collection mirror,
caches the extracted ``.mtx`` under ``cache_dir``, and returns a CSR.

Offline environments: place ``<Name>.mtx`` files in the cache directory
(or use the committed fixtures under ``data/``) — the loader checks the
cache before touching the network and raises a clear error when both are
unavailable.
"""

from __future__ import annotations

import io
import os
import tarfile
import urllib.request

from nsparse_jax.formats.csr import CSR
from nsparse_jax.io.matrix_market import read_mtx

_BASE = "https://suitesparse-collection-website.herokuapp.com/MM"
_DEFAULT_CACHE = os.path.join(
    os.path.expanduser("~"), ".cache", "nsparse_jax", "suitesparse"
)


def fetch(name: str, cache_dir: str | None = None, dtype=None) -> CSR:
    """Load ``Group/Name`` (e.g. ``"HB/west0479"``) as CSR.

    Looks in ``cache_dir`` first (``<Name>.mtx``); otherwise downloads
    ``<BASE>/<Group>/<Name>.tar.gz``, extracts the main ``.mtx``, caches
    it, and loads it.
    """
    if "/" not in name:
        raise ValueError(f"expected 'Group/Name', got {name!r}")
    group, mname = name.split("/", 1)
    cache_dir = cache_dir or _DEFAULT_CACHE
    path = os.path.join(cache_dir, f"{mname}.mtx")
    if not os.path.exists(path):
        os.makedirs(cache_dir, exist_ok=True)
        url = f"{_BASE}/{group}/{mname}.tar.gz"
        try:
            with urllib.request.urlopen(url, timeout=60) as r:
                blob = r.read()
        except Exception as e:
            raise RuntimeError(
                f"cannot fetch {name} ({e}); offline? place {mname}.mtx "
                f"in {cache_dir}"
            ) from e
        with tarfile.open(fileobj=io.BytesIO(blob), mode="r:gz") as tf:
            member = next(
                m for m in tf.getmembers()
                if m.name.endswith(f"{mname}.mtx")
            )
            data = tf.extractfile(member).read()
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, path)
    return read_mtx(path, dtype=dtype)

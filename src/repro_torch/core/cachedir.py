"""Versioned on-disk cache roots shared by every persistent artifact store.

The design cache (``pipeline.DesignCache``) and the tuning database
(``repro_torch.tune.TuningDB``) both persist artifacts whose layout follows the
compiler's own data structures, so a single format-version number governs
both: ``CACHE_FORMAT_VERSION`` is folded into every design hash *and* names
the on-disk directory level (``<root>/v<N>/<kind>/``).  Bumping it turns
every stale entry into a miss — and ``cache_root`` additionally *evicts*
sibling ``v<M>`` directories from older versions, so abandoned entries do
not accumulate forever.
"""

from __future__ import annotations

import os
import re
import shutil
import tempfile
from pathlib import Path
from typing import Optional, Union

#: Folded into every design hash and into the cache directory layout: bump
#: when Graph/Schedule/CompiledDesign layout, pass semantics, or the tuning
#: record schema change, so stale on-disk entries from older code versions
#: become cache misses instead of loading into incompatible objects.
#: v4: struct-of-arrays Graph serialisation (numpy columns replace the Op
#: list) and the column-bytes graph fingerprint.
CACHE_FORMAT_VERSION = 4

_VERSION_DIR = re.compile(r"^v\d+$")


def default_cache_base() -> Path:
    """Per-user base directory for all repro caches.

    ``$REPRO_TORCH_CACHE_DIR`` overrides; the default lives under the system temp
    dir, suffixed with the uid — cache entries include pickles and must
    never be shared between users.
    """
    env = os.environ.get("REPRO_TORCH_CACHE_DIR")
    if env:
        return Path(env)
    uid = os.getuid() if hasattr(os, "getuid") else "u"
    return Path(tempfile.gettempdir()) / f"repro_torch_cache_{uid}"


def evict_stale_versions(base: Union[str, Path], *,
                         keep_version: int = CACHE_FORMAT_VERSION) -> list[str]:
    """Delete ``v<M>`` cache trees under ``base`` for every ``M != keep``.

    Only directories matching ``v<digits>`` exactly are touched; anything
    else under ``base`` is left alone.  Returns the names removed (eviction
    is best-effort: a tree that cannot be removed is skipped).
    """
    base = Path(base)
    removed: list[str] = []
    if not base.is_dir():
        return removed
    for entry in base.iterdir():
        if (entry.is_dir() and _VERSION_DIR.match(entry.name)
                and entry.name != f"v{keep_version}"):
            try:
                shutil.rmtree(entry)
                removed.append(entry.name)
            except OSError:
                continue
    return removed


def cache_root(kind: str, *, base: Optional[Union[str, Path]] = None,
               version: int = CACHE_FORMAT_VERSION,
               evict_stale: bool = True) -> Path:
    """The managed cache directory for one artifact kind, e.g. ``designs``.

    Returns ``<base>/v<version>/<kind>`` (created 0700 if missing) and, by
    default, evicts sibling version trees first.  The port's root is its
    own (``repro_torch_cache_<uid>``), so neither package ever unpickles
    the other's designs.
    """
    base = Path(base) if base is not None else default_cache_base()
    base.mkdir(parents=True, exist_ok=True, mode=0o700)
    if evict_stale:
        evict_stale_versions(base, keep_version=version)
    root = base / f"v{version}" / kind
    root.mkdir(parents=True, exist_ok=True, mode=0o700)
    return root

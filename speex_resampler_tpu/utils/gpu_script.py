"""What the repo's GPU scripts share (not the library).

``chip_smoke.py`` and ``bench.py`` call :func:`use_compile_cache` and
print :func:`card_info`.  Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX
keeps its persistent compile cache there and no other directory is used;
otherwise the cache goes to the fixed path ``build/jax_cache`` in the
checkout, so reruns in one checkout hit it.  The library itself never
sets a cache.
"""

from __future__ import annotations

import os
import subprocess
from pathlib import Path

__all__ = ["card_info", "compile_cache_dir", "use_compile_cache"]


def card_info() -> str:
    """The card's name and power limit from nvidia-smi, read in a child
    process that never imports JAX (one JAX process per card)."""
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
        return (r.stdout or r.stderr).strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e!r}"


def compile_cache_dir(root: str | os.PathLike) -> Path:
    """The cache directory for a checkout rooted at ``root``."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    return Path(env) if env else Path(root) / "build" / "jax_cache"


def use_compile_cache(root: str | os.PathLike) -> Path:
    """Point JAX's persistent compile cache at compile_cache_dir(root)."""
    import jax
    d = compile_cache_dir(root)
    jax.config.update("jax_compilation_cache_dir", str(d))
    return d

"""Where the entry scripts keep JAX's persistent compilation cache.

``$JAX_COMPILATION_CACHE_DIR`` wins when it is set (JAX reads the
variable itself, so nothing else is configured).  Otherwise the cache
lives at ``<root>/.jax_cache`` inside the checkout: a fixed path, since
the path is part of the cache key and a moving directory never hits.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"


def cache_dir(root: str) -> str:
    """The cache directory for a checkout rooted at ``root``."""
    return os.environ.get(ENV_VAR) or os.path.join(
        os.path.abspath(root), ".jax_cache"
    )


def enable(root: str) -> str:
    """Point JAX's persistent compilation cache at :func:`cache_dir`;
    call before the first compile.  Returns the directory."""
    import jax

    path = cache_dir(root)
    if not os.environ.get(ENV_VAR):
        jax.config.update("jax_compilation_cache_dir", path)
    return path

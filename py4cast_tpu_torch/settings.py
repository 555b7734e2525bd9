"""Environment-driven settings: the data root, the cache dir and the
roots of the Titan, Poesy and Rainfall trees.

The same environment variables as the JAX package, so both packages
read one dataset tree and one cache (the dummy dataset's files are
bit-identical either way).
"""

import os
from pathlib import Path

DEFAULT_ROOT = Path(os.environ.get("PY4CAST_ROOTDIR", str(Path.home() / ".py4cast_tpu")))

ROOTDIR = Path(os.environ.get("PY4CAST_TPU_ROOTDIR", str(DEFAULT_ROOT)))
CACHE_DIR = Path(os.environ.get("PY4CAST_TPU_CACHE_DIR", str(ROOTDIR / "cache")))
TITAN_PATH = Path(os.environ.get("PY4CAST_TPU_TITAN_PATH", str(ROOTDIR / "titan")))
POESY_PATH = Path(os.environ.get("PY4CAST_TPU_POESY_PATH", str(ROOTDIR / "poesy")))
RAINFALL_PATH = Path(
    os.environ.get("PY4CAST_TPU_RAINFALL_PATH", str(ROOTDIR / "rainfall"))
)

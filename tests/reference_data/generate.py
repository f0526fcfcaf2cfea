"""Regenerate the JAX package's stored outputs (tests/reference_utils.py).

The JAX package is the frozen reference, so these files change only when the
inputs the port's tests make change (``load`` then names the file to make
again), or when a new file is added:

    python tests/reference_data/generate.py [name ...]     # from the repo's root

Each file is made in a process of its own (several large XLA:CPU programs in
one process have aborted it), under the conftest environment: CPU, x64, the
XLA engine. ``--one NAME [DIR]`` makes one file in this process, into DIR.
Commit the files with the change that asked for them; ``python -m pytest -m
slow tests/test_torch_reference_data.py`` shows every file bit-equal to a
fresh run.
"""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)


def _one(name, directory):
    import tests.conftest  # noqa: F401  (CPU, x64, XLA engine, compilation cache)
    from tests import reference_utils

    arrays = reference_utils.build(name)
    reference_utils.save(name, arrays, directory)
    size = os.path.getsize(reference_utils.path(name, directory))
    print(f"  {name}: {len(arrays)} arrays, {size} bytes", flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--one"]:
        from tests.reference_utils import DATA_DIR

        _one(sys.argv[2], sys.argv[3] if len(sys.argv) > 3 else DATA_DIR)
        sys.exit(0)
    from tests.reference_utils import FILES

    for name in sys.argv[1:] or FILES:
        print(f"generating {name} ...", flush=True)
        subprocess.run([sys.executable, os.path.abspath(__file__), "--one", name], cwd=ROOT, check=True)

"""The stored JAX outputs (tests/reference_utils.py) against the JAX package.

Each file is computed anew from the JAX package, in a process of its own as
tests/reference_data/generate.py makes it, and must equal the stored file bit
for bit: the port's tests may read the arrays instead of the reference's
programs. These are slow (the JAX programs compile for minutes on the CPU);
the list in the repo's root conftest.py marks them.

Run with:  python -m pytest tests/test_torch_reference_data.py -q -m slow
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from tests import reference_utils

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _fresh(name, tmp_path):
    """The file made anew by the generator, in a process of its own, into a
    scratch directory."""
    r = subprocess.run([sys.executable, os.path.join(reference_utils.DATA_DIR, "generate.py"), "--one", name,
                        str(tmp_path)], cwd=ROOT, capture_output=True, text=True)
    assert r.returncode == 0, r.stderr[-4000:]
    with np.load(reference_utils.path(name, str(tmp_path))) as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("name", sorted(reference_utils.FILES))
def test_stored_reference_is_bit_equal_to_the_jax_package(name, tmp_path):
    stored = reference_utils.load(name)
    fresh = _fresh(name, tmp_path)
    assert sorted(fresh) == sorted(stored), name
    differ = [k for k in stored if not reference_utils.bit_equal(fresh[k], stored[k])]
    assert not differ, f"{name}: {differ} differ from the JAX package's outputs"


def test_every_stored_file_is_listed():
    on_disk = sorted(f[:-4] for f in os.listdir(reference_utils.DATA_DIR) if f.endswith(".npz"))
    assert on_disk == sorted(reference_utils.FILES)

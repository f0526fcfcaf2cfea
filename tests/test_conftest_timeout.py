"""The time limit of the repo's root conftest.py: a test under tests/ that
runs past its limit fails with the hook's message and the run goes on; a test
elsewhere (port_bench/tests) runs without the hook.

Throwaway test files run in a pytest subprocess under a copy of that conftest.
"""

import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CASES = '''
import time

import pytest


@pytest.mark.timeout(1)
def test_sleeps_past_its_limit():
    time.sleep(30)


def test_quick():
    assert True
'''

ELSEWHERE = '''
import time

import pytest


@pytest.mark.timeout(1)
def test_sleeps_past_a_limit_no_hook_enforces():
    time.sleep(1.5)
'''


def test_a_test_past_its_limit_fails_and_the_run_goes_on(tmp_path):
    shutil.copy(os.path.join(ROOT, "conftest.py"), tmp_path / "conftest.py")
    for d, text in (("tests", CASES), ("elsewhere", ELSEWHERE)):
        (tmp_path / d).mkdir()
        (tmp_path / d / f"test_{d}.py").write_text(text)
    start = time.monotonic()
    r = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider", "-p", "no:xdist", "-p", "no:randomly",
         "-W", "error::pytest.PytestUnknownMarkWarning", "-c", os.path.join(ROOT, "pyproject.toml"),
         "--rootdir", str(tmp_path), str(tmp_path)],
        cwd=str(tmp_path), capture_output=True, text=True, timeout=120,
    )
    seconds = time.monotonic() - start
    assert r.returncode == 1, r.stdout[-3000:] + r.stderr[-3000:]
    assert "1 failed, 2 passed" in r.stdout, r.stdout[-3000:]
    assert "tests/test_tests.py::test_sleeps_past_its_limit: call ran past its time limit of 1 s" in r.stdout, (
        r.stdout[-3000:])
    assert seconds < 25, seconds

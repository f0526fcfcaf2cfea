"""The list of slow tests in the repo's root conftest.py against the tests
collected: each key is a collected node id, and every test that `-m slow`
selects is in the list (no slow mark comes from anywhere else)."""

import importlib.util
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _slow_list():
    spec = importlib.util.spec_from_file_location("root_conftest", os.path.join(ROOT, "conftest.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.SLOW


def test_slow_list_is_what_slow_collects():
    r = subprocess.run(
        [sys.executable, "-m", "pytest", "--collect-only", "-q", "-m", "slow", "-p", "no:cacheprovider",
         "-p", "no:xdist", "-p", "no:randomly", "tests/"],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
    )
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    collected = {line.strip() for line in r.stdout.splitlines() if "::" in line}
    slow = _slow_list()
    assert sorted(set(slow) - collected) == [], "listed as slow but not collected"
    assert sorted(collected - set(slow)) == [], "marked slow outside the list"
    assert all(entry.seconds > 0 and entry.why for entry in slow.values())

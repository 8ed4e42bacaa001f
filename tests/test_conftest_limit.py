"""The per-test limit of the repo's root conftest.py: a test past its limit
fails with a dump of every thread's stack, it runs only once, and the tests
after it still run.

Each case copies the conftest, with a limit of 2 s, beside a small `tests/`
directory and runs pytest on it in a subprocess.  `test_sleeps` overruns in
Python and is failed by the signal.  `test_stuck` blocks the signal, as native
code that does not return to Python does, so faulthandler ends its worker;
without xdist there is no hard exit, so the plain case leaves it out.  In the
loadfile case a second file keeps the other worker busy when the first one
ends, and xdist hands the stuck test's file on with the stuck test still in
it."""

import os
import re
import subprocess
import sys
import time
import xml.etree.ElementTree as ET

import pytest

TESTS = '''
import signal
import time


def test_sleeps():
    time.sleep(60)


def test_stuck():
    with open("starts", "a") as f:
        f.write("test_stuck\\n")
    signal.pthread_sigmask(signal.SIG_BLOCK, [signal.SIGALRM])
    time.sleep(120)


def test_passes():
    pass
'''

BUSY = '''
import time

import pytest


@pytest.mark.parametrize("i", range(16))
def test_busy(i):
    time.sleep(1)
'''

ROOT_CONFTEST = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "conftest.py")


@pytest.mark.parametrize("args", [
    ["-p", "no:xdist", "-k", "not stuck"],
    ["-p", "xdist", "-n", "2"],
    ["-p", "xdist", "-n", "2", "--dist", "loadfile"],
], ids=["plain", "xdist", "loadfile"])
def test_overrun_fails_and_the_rest_runs(tmp_path, args):
    with open(ROOT_CONFTEST) as f:
        conftest = f.read()
    assert "\nDEFAULT_LIMIT = 300\n" in conftest
    (tmp_path / "conftest.py").write_text(
        conftest.replace("\nDEFAULT_LIMIT = 300\n", "\nDEFAULT_LIMIT = 2\n"))
    (tmp_path / "tests").mkdir()
    (tmp_path / "tests" / "test_limits.py").write_text(TESTS)
    (tmp_path / "tests" / "test_busy.py").write_text(BUSY)
    env = {k: v for k, v in os.environ.items() if not k.startswith("PYTEST_")}
    t0 = time.monotonic()
    run = subprocess.run(
        [sys.executable, "-m", "pytest", "tests", "--rootdir", str(tmp_path),
         "-p", "no:cacheprovider", "-p", "no:randomly",
         "--junitxml", str(tmp_path / "out.xml")] + args,
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    seconds = time.monotonic() - t0
    out = run.stdout + run.stderr
    stuck = "not stuck" not in args
    # uncut, test_stuck alone would take 120 s; the rest is start-up
    assert seconds < 90, out

    cases = {}
    for case in ET.parse(tmp_path / "out.xml").iter("testcase"):
        name = case.get("name")
        if name == "test_sleeps":
            assert float(case.get("time")) < 2 + 30, out
        # xdist reports a crashed worker's test as an error of no phase
        bad = case.findall("failure") + case.findall("error")
        cases.setdefault(name, set()).add("failed" if bad else "passed")
    want = {"test_sleeps": {"failed"}, "test_passes": {"passed"}}
    want.update({f"test_busy[{i}]": {"passed"} for i in range(16)})
    if stuck:
        want["test_stuck"] = {"failed"}
    assert cases == want, out
    assert "ran over its limit of 2 s" in out, out
    assert "in test_sleeps" in out, out          # the signal's stack dump
    if stuck:
        assert re.search(r"Timeout \(0:00:\d\d\)!", out), out
        assert "in test_stuck" in out, out       # faulthandler's
        assert "node down" in out or "crashed" in out, out
        assert (tmp_path / "starts").read_text() == "test_stuck\n", out

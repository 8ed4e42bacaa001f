"""Limits on the tests under tests/, and the list of those that are slow.

Every phase of such a test (setup, call, teardown) has a limit of
DEFAULT_LIMIT seconds, unless the test is marked `slow`: two of those ran past
3,600 s alone, and none has a measured bound.  At the limit SIGALRM dumps
every thread's stack and fails the test.  The signal waits for the main thread
to come back to Python, which an XLA:CPU compile does only at its end.  So on
an xdist worker faulthandler dumps the stacks again GRACE seconds later and
ends the process: xdist reports the test as failed and hands the rest of its
file to a new worker, where that test fails at once instead of running again.
Without xdist there is no hard exit, and a test held in native code fails when
it comes back.

Tier-1 is `pytest tests/ -m 'not slow' -n 6 --dist loadfile`, and
`pytest tests/ -m slow` runs the rest.  A test is in SLOW only if it holds the
JAX package against itself (its device, Pallas or mesh engine against its own
host oracle or `lax.scan`) and either took over DEFAULT_LIMIT alone or, beside
five other workers in tier-1, failed at that limit or took over 80% of it.

Seconds of each test alone (one file a process, two other files running,
8-core CPU host, no compile cache; "> 300": cut there), and in parentheses the
most it took in a run of tier-1 before it was marked or since:

  file (tests, slow)           tier-1 tests          slow tests
  test_device_engine (3, 3)                          > 300 each
  test_multichip (6, 4)        7, 6                  dry-run, partitioned MSM,
                                                     padded shard > 300;
                                                     bit-serial MSM 234
                                                     (failed at 300 in tier-1)
  test_ec14 (4, 3)             sum steps 195 (141)   scan 181 (260 in tier-1),
                                                     em layout 189 (298), MSM
                                                     > 300
  test_device_compile (2, 1)   setup 129 (220)       compile > 300
  test_readme_circuit (2, 1)   5                     device proof > 300
  test_sharded_engine (1, 1)                         > 300
  test_sharded_pippenger (1, 1)                      > 300
  test_ec_scan_kernel (2, 0)   106 (219), 136 (210)
  test_torch_msm_kernels (10)  202 (187) for one test, the port against Pallas
  the other 53 files           134 at most
"""

import contextlib
import faulthandler
import hashlib
import os
import shutil
import signal
import tempfile
import threading
from pathlib import Path

import pytest

TESTS = Path(__file__).resolve().parent / "tests"
DEFAULT_LIMIT = 300
GRACE = 10

SLOW = frozenset([
    "tests/test_device_compile.py::test_compile_device_matches_host",
    "tests/test_device_engine.py::test_device_negative_unsatisfied",
    "tests/test_device_engine.py::test_device_proof_equals_host_boolean",
    "tests/test_device_engine.py::test_device_proof_equals_host_mixed",
    "tests/test_ec14.py::test_msm_full_14_interpret",
    "tests/test_ec14.py::test_scan_mixed14_em_layout_matches",
    "tests/test_ec14.py::test_scan_mixed14_matches_16",
    "tests/test_multichip.py::test_dryrun_multichip",
    "tests/test_multichip.py::test_msm_bit_serial_matches_host",
    "tests/test_multichip.py::test_msm_local_totals_padded_shard",
    "tests/test_multichip.py::test_msm_partitioned_matches_host",
    "tests/test_readme_circuit.py::test_readme_circuit_device_matches_host",
    "tests/test_sharded_engine.py::test_sharded_proof_equals_host",
    "tests/test_sharded_pippenger.py::test_sharded_pippenger_proof_equals_host",
])

_DUMP_FD = pytest.StashKey[int]()
_RUNNING = pytest.StashKey[str]()


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: the JAX engine held against itself, minutes of "
        "XLA:CPU compiles; left out of tier-1 (-m 'not slow')")
    # The stacks go to the real stderr, not to a capture file that a process
    # ended by faulthandler never reports.
    cap = config.pluginmanager.getplugin("capturemanager")
    with (cap.global_and_fixture_disabled() if cap is not None
          else contextlib.nullcontext()):
        config.stash[_DUMP_FD] = os.dup(2)


@pytest.hookimpl(tryfirst=True)
def pytest_collection_modifyitems(items):
    for item in items:
        if f"{os.path.relpath(item.path, TESTS.parent)}::{item.name}" in SLOW:
            item.add_marker(pytest.mark.slow)


@pytest.hookimpl(optionalhook=True)
def pytest_configure_node(node):
    """Every xdist worker records there the test phase it is in."""
    stash = node.config.stash
    if _RUNNING not in stash:
        stash[_RUNNING] = tempfile.mkdtemp(prefix="tests-running-")
    node.workerinput["tests_running"] = stash[_RUNNING]


def pytest_unconfigure(config):
    if _RUNNING in config.stash:
        shutil.rmtree(config.stash[_RUNNING], ignore_errors=True)


@contextlib.contextmanager
def _limited(item, setup=False):
    if not item.path.is_relative_to(TESTS) or item.get_closest_marker("slow"):
        yield
        return
    fd = item.config.stash[_DUMP_FD]
    worker = getattr(item.config, "workerinput", None)
    record = worker and Path(worker["tests_running"],
                             hashlib.sha1(item.nodeid.encode()).hexdigest())
    if setup and record and record.exists():
        pytest.fail(f"{item.nodeid} ended its worker before; not run again")

    def overrun(signum, frame):
        faulthandler.dump_traceback(file=fd, all_threads=True)
        pytest.fail(f"{item.nodeid} ran over its limit of {DEFAULT_LIMIT} s")

    # signal handlers can only be set from the main thread
    soft = threading.current_thread() is threading.main_thread()
    if soft:
        previous = signal.signal(signal.SIGALRM, overrun)
        signal.setitimer(signal.ITIMER_REAL, DEFAULT_LIMIT)
    if record:
        record.touch()
        faulthandler.dump_traceback_later(DEFAULT_LIMIT + GRACE, file=fd,
                                          exit=True)
    try:
        yield
    finally:
        if record:
            faulthandler.cancel_dump_traceback_later()
            record.unlink(missing_ok=True)
        if soft:
            signal.setitimer(signal.ITIMER_REAL, 0)
            signal.signal(signal.SIGALRM, previous)


@pytest.hookimpl(wrapper=True)
def pytest_runtest_setup(item):
    with _limited(item, setup=True):
        return (yield)


@pytest.hookimpl(wrapper=True)
def pytest_runtest_call(item):
    with _limited(item):
        return (yield)


@pytest.hookimpl(wrapper=True)
def pytest_runtest_teardown(item):
    with _limited(item):
        return (yield)

"""Tier-1 policy for the tests under ``tests/``.

- The tests of ``SLOW_FILE`` are marked ``slow``, so that the tier-1
  command's ``-m 'not slow'`` leaves them out; ``-m slow`` runs them.
- Every test not marked ``slow`` gets a wall limit, ``TEST_TIME_LIMIT``, over
  its setup and call,
  and the same again for its teardown. SIGALRM fails a test that runs past it.
  A test stuck in a C call ignores that signal, so ``BACKSTOP`` seconds later
  faulthandler writes every thread's traceback and ends the process.
- Under pytest-xdist a worker keeps a note file while it runs a test. xdist
  hands the test that a dead worker held to a fresh worker, so a test whose
  note a dead worker left behind fails at once instead of running again.
- The tests that read the ls1-MarDyn checkout (``NEEDS_REFERENCE``) skip where
  it is absent, and run unchanged where it exists.

This file imports neither JAX nor PyTorch: ``tests/conftest.py`` must set
``XLA_FLAGS`` before JAX starts. The ``slow`` marker is registered there.
There is no pytest ini file, which would move the rootdir and the confcutdir.
"""

import faulthandler
import hashlib
import os
import signal
import time
from contextlib import contextmanager
from pathlib import Path

import pytest

TESTS = Path(__file__).resolve().parent / "tests"

# Seconds. The slowest test left in the run, test_ewald_driver.py::
# test_driver_fmm_matches_ewald, takes 260-300 s under the tier-1 command on an
# 8-core CPU machine. A hung test holds its worker for the limit plus the
# backstop on top of a run that ends at ~820 s, which must stay well inside the
# command's 1470 s clock.
TEST_TIME_LIMIT = 480
BACKSTOP = 60

# The sharded FMM on 8 virtual CPU devices: JAX only, with no port counterpart.
# Its five tests take 927, 715, 479, 207 and 195 s of cold XLA compile on an
# 8-core CPU machine, ~42 min on one worker under --dist loadfile. Marked slow,
# they run without the limit: python -m pytest tests/ -m slow.
SLOW_FILE = TESTS / "test_fmm_multichip.py"

# Node ids without their parameters: each reads input files or example
# configurations from the ls1-MarDyn checkout.
NEEDS_REFERENCE = {
    "tests/test_binary_checkpoint.py::test_driver_binary_restart",
    "tests/test_cellforce_lanes.py::test_lanes_path_matches_oracle",
    "tests/test_cellforce_vs_oracle.py::test_cell_path_matches_oracle",
    "tests/test_driver_xml.py::test_cli_profile_trace",
    "tests/test_driver_xml.py::test_cli_smoke",
    "tests/test_driver_xml.py::test_driver_runs_argon_and_restarts",
    "tests/test_driver_xml.py::test_parse_reference_argon_config",
    "tests/test_driver_xml.py::test_plugin_hook_order",
    "tests/test_oracle_forces.py::test_force_calculation_f0",
    "tests/test_oracle_forces.py::test_force_calculation_u0",
    "tests/test_oracle_forces.py::test_newton_third_law_random_multisite",
    "tests/test_oracle_forces.py::test_reader_1clj_scene",
    "tests/test_oracle_forces.py::test_reader_water_scene",
    "tests/test_pallas_ms_packed.py::test_packed_matches_oracle",
    "tests/test_pallas_multisite.py::test_ms_kernel_matches_oracle",
    "tests/test_pallas_multisite.py::test_ms_kernel_windowed_matches_oracle",
}

_STDERR = pytest.StashKey[int]()
_NOTES = pytest.StashKey["Path | None"]()
_DEADLINE = pytest.StashKey[float]()


def _governed(item):
    return TESTS in item.path.parents and item.get_closest_marker("slow") is None


def _reference_input(config):
    """tests/conftest.py's REFERENCE_INPUT, or None where it is not loaded."""
    # pytest registers a conftest under its path.
    return getattr(
        config.pluginmanager.get_plugin(str(TESTS / "conftest.py")),
        "REFERENCE_INPUT",
        None,
    )


def pytest_configure(config):
    # Capture is suspended here, so fd 2 is the real stderr; pytest's capture
    # file would be lost with a worker that the backstop ends.
    config.stash[_STDERR] = os.dup(2)
    notes = None
    if hasattr(config, "workerinput"):
        # xdist gives each worker <the session's base temp>/popen-gwN.
        notes = Path(config.option.basetemp).parent / "running-tests"
        notes.mkdir(parents=True, exist_ok=True)
    config.stash[_NOTES] = notes


def pytest_unconfigure(config):
    os.close(config.stash[_STDERR])


@pytest.hookimpl(tryfirst=True)
def pytest_collection_modifyitems(config, items):
    # tryfirst: the marks must be on before `-m` deselects.
    ref = _reference_input(config)
    skip = None
    if ref is not None and not os.path.exists(ref):
        skip = pytest.mark.skip(
            reason=f"needs {os.path.dirname(ref)} (ls1-MarDyn checkout), absent"
        )
    for item in items:
        if item.path == SLOW_FILE:
            item.add_marker(pytest.mark.slow)
        if skip is not None and item.nodeid.split("[", 1)[0] in NEEDS_REFERENCE:
            item.add_marker(skip)


def _note(item):
    notes = item.config.stash[_NOTES]
    if notes is None:
        return None
    return notes / hashlib.sha1(item.nodeid.encode()).hexdigest()


@contextmanager
def _limit(item, deadline):
    def expire(signum, frame):
        pytest.fail(
            f"{item.nodeid} exceeded the per-test limit of {TEST_TIME_LIMIT:g} s"
        )

    left = max(deadline - time.monotonic(), 1e-3)
    previous = signal.signal(signal.SIGALRM, expire)
    signal.setitimer(signal.ITIMER_REAL, left)
    faulthandler.dump_traceback_later(
        left + BACKSTOP, exit=True, file=item.config.stash[_STDERR]
    )
    try:
        yield
    finally:
        faulthandler.cancel_dump_traceback_later()
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, previous)


@pytest.hookimpl(wrapper=True)
def pytest_runtest_setup(item):
    if not _governed(item):
        return (yield)
    note = _note(item)
    if note is not None:
        if note.exists():
            pytest.fail(
                f"{item.nodeid} was running when its worker died (limit "
                f"{TEST_TIME_LIMIT:g} s, backstop {BACKSTOP:g} s more); "
                "not run again",
                pytrace=False,
            )
        note.write_text(item.nodeid)
    item.stash[_DEADLINE] = time.monotonic() + TEST_TIME_LIMIT
    with _limit(item, item.stash[_DEADLINE]):
        return (yield)


@pytest.hookimpl(wrapper=True)
def pytest_runtest_call(item):
    if not _governed(item):
        return (yield)
    with _limit(item, item.stash[_DEADLINE]):
        return (yield)


@pytest.hookimpl(wrapper=True)
def pytest_runtest_teardown(item):
    if not _governed(item):
        return (yield)
    try:
        with _limit(item, time.monotonic() + TEST_TIME_LIMIT):
            return (yield)
    finally:
        note = _note(item)
        if note is not None:
            note.unlink(missing_ok=True)

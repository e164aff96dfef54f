"""The tier-1 policy of the repository's root conftest.py.

The limit's cases run a throwaway test file under a copy of that conftest in a
subprocess pytest, with the limit lowered to 1 s and the backstop to 2 s. The
list cases collect ``tests/`` (no run), so that a renamed test cannot drop out
of the reference-skip list unnoticed, and ``-m slow`` selects the sharded-FMM
file's five tests and nothing else.
"""

import importlib.util
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

_spec = importlib.util.spec_from_file_location("root_conftest", ROOT / "conftest.py")
policy = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(policy)

BLOCKS_ALARM = """\
import signal
import time


def test_blocks_alarm():
    # Stands in for a C call, which Python's SIGALRM handler cannot interrupt.
    signal.pthread_sigmask(signal.SIG_BLOCK, {signal.SIGALRM})
    time.sleep(60)


def test_next():
    pass
"""


def _pytest(args, cwd, timeout=120):
    env = {k: v for k, v in os.environ.items() if not k.startswith("PYTEST_")}
    run = subprocess.run(
        [sys.executable, "-m", "pytest", "-p", "no:cacheprovider",
         "-p", "no:randomly", *args],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=timeout,
    )
    return run.returncode, run.stdout + run.stderr


def _throwaway_tree(tmp_path, body, name="test_throwaway.py"):
    """A tree with the root conftest, its limit at 1 s and its backstop at 2 s."""
    text = (ROOT / "conftest.py").read_text()
    for old, new in (("TEST_TIME_LIMIT = 480\n", "TEST_TIME_LIMIT = 1\n"),
                     ("BACKSTOP = 60\n", "BACKSTOP = 2\n")):
        assert old in text
        text = text.replace(old, new)
    (tmp_path / "conftest.py").write_text(text)
    (tmp_path / "tests").mkdir()
    (tmp_path / "tests" / name).write_text(body)
    return ["tests", f"--basetemp={tmp_path / 'basetemp'}"]


def test_sleeping_test_fails_at_the_limit(tmp_path):
    args = _throwaway_tree(
        tmp_path, "import time\n\n\ndef test_sleeps():\n    time.sleep(60)\n"
    )
    start = time.monotonic()
    rc, out = _pytest(args, tmp_path)
    assert time.monotonic() - start < 30, out
    assert rc == 1, out
    assert (
        "tests/test_throwaway.py::test_sleeps exceeded the per-test limit of 1 s"
        in out
    ), out
    assert "1 failed" in out, out


def test_worker_past_the_backstop_dies_and_its_test_is_not_rerun(tmp_path):
    args = _throwaway_tree(tmp_path, BLOCKS_ALARM)
    rc, out = _pytest(
        [*args, "-p", "xdist", "-n", "1", "--dist", "loadfile"], tmp_path
    )
    assert rc == 1, out
    # faulthandler's dump names the frame the worker was stuck in.
    assert "in test_blocks_alarm" in out, out
    assert out.count("node down") == 1, out
    assert "test_blocks_alarm was running when its worker died" in out, out
    assert "not run again" in out, out
    assert "1 passed" in out, out


def test_slow_file_runs_without_the_limit(tmp_path):
    args = _throwaway_tree(
        tmp_path,
        "import time\n\n\ndef test_sleeps_past_the_limit():\n    time.sleep(3)\n",
        name=policy.SLOW_FILE.name,
    )
    rc, out = _pytest([*args, "-m", "slow"], tmp_path)
    assert rc == 0, out
    assert "1 passed" in out, out


def _collected(*args):
    rc, out = _pytest(["tests/", "--collect-only", "-q", *args], ROOT, timeout=300)
    assert rc == 0, out[-4000:]
    return {line for line in out.splitlines() if "::" in line}


def test_listed_tests_exist():
    ids = {i.split("[", 1)[0] for i in _collected()}
    assert sorted(policy.NEEDS_REFERENCE - ids) == []


def test_slow_selects_the_sharded_fmm_tests():
    ids = _collected("-m", "slow")
    assert len(ids) == 5, ids
    assert all(i.startswith(f"tests/{policy.SLOW_FILE.name}::") for i in ids), ids

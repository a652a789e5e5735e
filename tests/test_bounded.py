"""``_bounded.run_bounded`` kills the whole process group of a command
past its limit."""

import os
import time

import pytest
from _bounded import run_bounded


def _gone(pid, within):
    """Whether ``pid`` names no process within ``within`` seconds (a killed
    orphan is reaped by the system, not by us)."""
    deadline = time.monotonic() + within
    while time.monotonic() < deadline:
        try:
            os.kill(pid, 0)
        except ProcessLookupError:
            return True
        time.sleep(0.05)
    return False


def test_run_bounded_kills_the_grandchild_at_its_limit(tmp_path):
    pid_file = tmp_path / "grandchild.pid"
    t0 = time.monotonic()
    with pytest.raises(pytest.fail.Exception, match="still running after 2 s"):
        run_bounded(["sh", "-c", f"sleep 600 & echo $! > {pid_file}; wait"],
                    timeout=2)
    assert time.monotonic() - t0 < 10
    assert _gone(int(pid_file.read_text()), within=10)

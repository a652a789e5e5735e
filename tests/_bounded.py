"""The one way a CPU test of the port starts a process: ``run_bounded``."""

import os
import signal
import subprocess

import pytest


def _kill_group(pgid):
    try:
        os.killpg(pgid, signal.SIGKILL)
    except ProcessLookupError:
        pass


def run_bounded(cmd, timeout, **kw):
    """Run ``cmd`` to its end and return its ``CompletedProcess``, with
    stdout and stderr captured as text; ``kw`` goes to ``Popen``.

    The command starts a session of its own.  Past ``timeout`` seconds
    every process of that session's group is killed, the command is
    reaped and the test fails with the command and the tail of its
    output.  A process the command leaves behind is killed with it on
    every return.
    """
    with subprocess.Popen(cmd, stdout=subprocess.PIPE,
                          stderr=subprocess.PIPE, text=True,
                          start_new_session=True, **kw) as proc:
        try:
            out, err = proc.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            _kill_group(proc.pid)
            out, err = proc.communicate()
            pytest.fail(f"still running after {timeout} s, killed: {cmd}\n"
                        f"--- stdout tail ---\n{out[-2000:]}\n"
                        f"--- stderr tail ---\n{err[-4000:]}",
                        pytrace=False)
        finally:
            _kill_group(proc.pid)
    return subprocess.CompletedProcess(cmd, proc.returncode, out, err)

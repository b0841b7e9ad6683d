"""A time limit for each of the port's tests.

Each setup and each call of a port test (tests/test_torch_*.py) must end
within TEST_LIMIT_S seconds: past it the test fails with its stack.  A
worker that cannot get back to Python to fail it (a native call that
never returns) prints every thread's stack HUNG_WORKER_S seconds later and
exits, so that the run goes on without it.  The JAX package's own tests
have no limit of their own: under six xdist workers on an 8-core CPU some
of their Pallas interpret-mode and shard_map tests take 5 to 23 minutes,
and tests/test_parallel.py::test_grads_replicated_after_psum 17 minutes
alone on an idle one.

This file sits at the root so that pytest loads it before
tests/conftest.py, which sets up JAX.
"""
import contextlib
import faulthandler
import os
import signal
import threading

import pytest

# about six times the longest port test of a whole run under six xdist
# workers (48 s)
TEST_LIMIT_S = 300
# how long a worker stuck in native code past the limit lives on
HUNG_WORKER_S = 120

_stderr = None     # the process's own stderr, which pytest does not capture


def pytest_configure(config):
    global _stderr
    capman = config.pluginmanager.getplugin("capturemanager")
    with (capman.global_and_fixture_disabled() if capman
          else contextlib.nullcontext()):
        _stderr = os.fdopen(os.dup(2), "w")


def pytest_unconfigure(config):
    if _stderr is not None:
        _stderr.close()


@contextlib.contextmanager
def _time_limit(item, what):
    if not item.path.name.startswith("test_torch_"):
        yield
        return

    def expire(signum, frame):
        pytest.fail(f"{what} passed the {TEST_LIMIT_S} s limit of a test")

    faulthandler.dump_traceback_later(TEST_LIMIT_S + HUNG_WORKER_S,
                                      exit=True, file=_stderr)
    main = threading.current_thread() is threading.main_thread()
    if main:
        old = signal.signal(signal.SIGALRM, expire)
        signal.setitimer(signal.ITIMER_REAL, TEST_LIMIT_S)
    try:
        yield
    finally:
        if main:
            signal.setitimer(signal.ITIMER_REAL, 0)
            signal.signal(signal.SIGALRM, old)
        faulthandler.cancel_dump_traceback_later()


@pytest.hookimpl(wrapper=True)
def pytest_runtest_setup(item):
    with _time_limit(item, f"the setup of {item.nodeid}"):
        return (yield)


@pytest.hookimpl(wrapper=True)
def pytest_runtest_call(item):
    with _time_limit(item, item.nodeid):
        return (yield)

"""A pytest plugin that runs every test under the port's shmemcheck
(the counterpart of the reference's ``tests/conftest.py`` arm):

    REPRO_SHMEMCHECK=1 PYTHONPATH=src python -m pytest \\
        -p repro_torch.analysis.pytest_arm tests/test_torch_ordering.py

With ``REPRO_SHMEMCHECK=1`` the port's checker is enabled with fresh
state before each test, and any finding it accumulated fails the owning
test at teardown (pytest reports an error in that test's teardown), so
a race is attributed to the test that raced.  All
findings are also written to ``shmemcheck-report.json`` under pytest's
session tmp dir, or to the path in ``REPRO_SHMEMCHECK_REPORT``.  Tests
that deliberately explore racy interleavings opt out with
``@pytest.mark.shmem_racy`` (the marker ``tests/conftest.py``
registers): the checker is suspended for them.  Without the variable
the plugin does nothing.
"""
import json
import os
import tempfile

import pytest

_ENABLED = os.environ.get("REPRO_SHMEMCHECK") == "1"
_ALL: list[dict] = []


def pytest_runtest_setup(item):
    if not _ENABLED:
        return
    from repro_torch.analysis import shmemcheck
    if item.get_closest_marker("shmem_racy"):
        shmemcheck.disable()
        return
    shmemcheck.enable().reset()


@pytest.hookimpl(wrapper=True)
def pytest_runtest_teardown(item, nextitem):
    # after the test's own teardown (its fixtures' drains included), so
    # the teardown chain stays whole when a finding fails the test
    yield
    if not _ENABLED or item.get_closest_marker("shmem_racy"):
        return
    from repro_torch.analysis import shmemcheck
    chk = shmemcheck.get_checker()
    if chk is None:
        return
    findings = chk.report()
    if not findings:
        return
    _ALL.extend({"test": item.nodeid, "rule": f.rule, "loc": f.loc,
                 "other_loc": f.other_loc, "message": f.message}
                for f in findings)
    lines = "\n".join(f"  {f}" for f in findings)
    chk.reset()
    pytest.fail(f"shmemcheck: {len(findings)} memory-model finding(s):\n"
                f"{lines}", pytrace=False)


def _report_path(config) -> str:
    override = os.environ.get("REPRO_SHMEMCHECK_REPORT")
    if override:
        return override
    try:
        base = str(config._tmp_path_factory.getbasetemp())
    except (AttributeError, OSError):
        base = tempfile.gettempdir()
    return os.path.join(base, "shmemcheck-report.json")


def pytest_sessionfinish(session, exitstatus):
    if not _ENABLED:
        return
    with open(_report_path(session.config), "w", encoding="utf-8") as fh:
        json.dump({"findings": _ALL, "count": len(_ALL)}, fh, indent=2)

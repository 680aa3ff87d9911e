"""The port's ``launch/env.py`` against ``tests/test_env.py``'s cases.

tcmalloc discovery (the reference's ``find_tcmalloc`` finds the same
library, or none, on this machine), its env pairs, ``apply``'s
reporting, the argparse glue's no-op default and its missing-library
warning, with the reference test's expectations; the flags with no torch
meaning are absent, and importing the planner's modules sets no
environment variable.
"""

import argparse
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.launch import env as ref_envmod  # noqa: E402
from repro_torch.launch import env as envmod  # noqa: E402

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")


class TestTcmalloc:
    def test_finds_what_the_reference_finds(self):
        assert envmod.find_tcmalloc() == ref_envmod.find_tcmalloc()

    def test_env_pairs_or_empty(self):
        env = envmod.tcmalloc_env()
        lib = envmod.find_tcmalloc()
        if lib is None:
            assert env == {}
        else:
            assert lib in env["LD_PRELOAD"]
            assert "TCMALLOC_LARGE_ALLOC_REPORT_THRESHOLD" in env

    def test_env_pairs_with_a_library(self, monkeypatch):
        """A found library (planted, so the case runs on any image) is
        appended to the user's preload, once."""
        monkeypatch.setattr(envmod, "find_tcmalloc", lambda: "/lib/libtcmalloc.so.4")
        monkeypatch.setenv("LD_PRELOAD", "/lib/other.so")
        env = envmod.tcmalloc_env()
        assert env["LD_PRELOAD"] == "/lib/other.so:/lib/libtcmalloc.so.4"
        assert env["TCMALLOC_LARGE_ALLOC_REPORT_THRESHOLD"] == "60000000000"
        monkeypatch.setenv("LD_PRELOAD", "/lib/libtcmalloc.so.4")
        assert envmod.tcmalloc_env()["LD_PRELOAD"].split(":").count("/lib/libtcmalloc.so.4") == 1

    def test_preload_not_duplicated(self, monkeypatch):
        lib = envmod.find_tcmalloc()
        if lib is None:
            pytest.skip("no libtcmalloc in image")
        monkeypatch.setenv("LD_PRELOAD", lib)
        assert envmod.tcmalloc_env()["LD_PRELOAD"].split(":").count(lib) == 1


class TestApply:
    def test_sets_and_reports_changes(self, monkeypatch):
        monkeypatch.delenv("REPRO_TEST_KEY", raising=False)
        changed = envmod.apply({"REPRO_TEST_KEY": "1"})
        assert changed == {"REPRO_TEST_KEY": "1"}
        assert os.environ["REPRO_TEST_KEY"] == "1"
        assert envmod.apply({"REPRO_TEST_KEY": "1"}) == {}   # idempotent
        monkeypatch.delenv("REPRO_TEST_KEY")


class TestArgparseGlue:
    def _parse(self, argv):
        ap = argparse.ArgumentParser()
        envmod.add_env_args(ap)
        return ap.parse_args(argv)

    def test_defaults_are_noop(self, monkeypatch):
        monkeypatch.delenv("XLA_FLAGS", raising=False)
        before = dict(os.environ)
        args = self._parse([])
        assert envmod.apply_env_args(args) == {}
        assert dict(os.environ) == before

    def test_missing_tcmalloc_warns_not_raises(self, monkeypatch):
        args = self._parse(["--tcmalloc"])
        monkeypatch.setattr(envmod, "find_tcmalloc", lambda: None)
        with pytest.warns(UserWarning, match="libtcmalloc"):
            assert envmod.apply_env_args(args) == {}

    def test_no_xla_flags(self):
        """``--x64``, ``--host-devices`` and ``--xla-preset`` have no torch
        meaning and are not offered."""
        for flag in ("--x64", "--host-devices", "--xla-preset"):
            with pytest.raises(SystemExit):
                self._parse([flag] + (["2"] if flag != "--x64" else []))
        assert not hasattr(envmod, "xla_flags") and not hasattr(envmod, "enable_x64")

    @pytest.mark.parametrize("user_preload", ["", "/lib/other.so"])
    def test_tcmalloc_flag_exports_the_preload(self, monkeypatch, user_preload):
        """``--tcmalloc`` with a library found (planted) exports the preload
        and the report threshold for child processes, after the user's own
        preload, and reports both as changed."""
        monkeypatch.setattr(envmod, "find_tcmalloc", lambda: "/lib/libtcmalloc.so.4")
        monkeypatch.setenv("LD_PRELOAD", user_preload)
        monkeypatch.delenv("TCMALLOC_LARGE_ALLOC_REPORT_THRESHOLD", raising=False)
        want = f"{user_preload}:/lib/libtcmalloc.so.4".strip(":")
        changed = envmod.apply_env_args(self._parse(["--tcmalloc"]))
        assert changed == {"LD_PRELOAD": want,
                           "TCMALLOC_LARGE_ALLOC_REPORT_THRESHOLD": "60000000000"}
        assert os.environ["LD_PRELOAD"] == want


def test_importing_the_planner_sets_no_environment_variable():
    """A fresh process's environment after importing every planning module
    is the one it started with (the reference's dry-run sets XLA_FLAGS at
    import)."""
    script = ("import os, json; before = dict(os.environ); "
              "import repro_torch.launch.specs, repro_torch.launch.dryrun, "
              "repro_torch.launch.roofline_report, repro_torch.launch.env, "
              "repro_torch.core.roofline; "
              "print(json.dumps(dict(os.environ) == before))")
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         env={"PYTHONPATH": os.path.abspath(SRC), "OMP_NUM_THREADS": "1",
                              "PATH": os.environ.get("PATH", "/usr/bin:/bin")})
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "true"

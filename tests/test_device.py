"""The capability module (utils/device.py), the compile-cache placement,
and the measurement entry points' refusal to run on the CPU by accident."""

import os
import subprocess
import sys
import types
from pathlib import Path

import jax
import pytest

from tpu3drecon.utils import compile_cache, device

REPO = Path(__file__).resolve().parents[1]


def _fake_device(platform="gpu", kind="NVIDIA H100 80GB HBM3", stats=None):
    return types.SimpleNamespace(
        platform=platform, device_kind=kind, memory_stats=lambda: stats,
    )


class TestDeviceInfo:
    def test_reports_jax_view(self):
        info = device.device_info()
        assert info.platform == jax.devices()[0].platform == "cpu"
        assert info.device_kind == jax.devices()[0].device_kind
        assert info.count == len(jax.devices())
        assert info.as_dict() == {
            "platform": info.platform,
            "device_kind": info.device_kind,
            "count": info.count,
        }

    def test_measurement_path_refuses_cpu(self):
        with pytest.raises(device.NoAcceleratorError, match="--cpu"):
            device.require_accelerator(what="the benchmark")

    def test_measurement_path_accepts_gpu(self):
        devs = [_fake_device(), _fake_device()]
        info = device.require_accelerator(devs)
        assert info == device.DeviceInfo("gpu", "NVIDIA H100 80GB HBM3", 2)

    def test_no_devices_is_an_error(self):
        with pytest.raises(RuntimeError, match="no devices"):
            device.device_info([])


class TestMemory:
    @pytest.mark.parametrize("limit", [16_000_000_000, 60_129_542_144])
    def test_bytes_limit_read_from_memory_stats(self, limit):
        dev = _fake_device(stats={"bytes_limit": limit, "bytes_in_use": 7})
        assert device.memory_bytes(dev) == limit

    @pytest.mark.parametrize(
        "stats", [None, {}, {"bytes_limit": 0}], ids=["none", "empty", "zero"]
    )
    def test_unknown_limit_is_an_error(self, stats):
        with pytest.raises(RuntimeError, match="memory limit"):
            device.memory_bytes(_fake_device(stats=stats))

    @pytest.mark.parametrize(
        "stats,expected",
        [({"peak_bytes_in_use": 123}, 123), (None, None), ({}, None)],
        ids=["reported", "none", "missing"],
    )
    def test_peak_bytes_in_use(self, stats, expected):
        assert device.peak_bytes_in_use(_fake_device(stats=stats)) == expected


class TestNvidiaSmi:
    def test_absent_tool_gives_none(self, monkeypatch):
        monkeypatch.setattr(device.shutil, "which", lambda name: None)
        assert device.nvidia_smi_name_and_power_limit() is None

    def test_queries_name_and_power_limit(self, monkeypatch):
        seen = {}

        def fake_run(cmd, **kw):
            seen["cmd"] = cmd
            return types.SimpleNamespace(stdout="NVIDIA H100 80GB HBM3, 700.00 W\n")

        monkeypatch.setattr(device.shutil, "which", lambda name: "/bin/smi")
        monkeypatch.setattr(device.subprocess, "run", fake_run)
        out = device.nvidia_smi_name_and_power_limit()
        assert out == "NVIDIA H100 80GB HBM3, 700.00 W"
        assert seen["cmd"][1:] == [
            "--query-gpu=name,power.limit", "--format=csv,noheader"
        ]


class TestCompileCache:
    @pytest.fixture
    def updates(self, monkeypatch):
        calls = []
        monkeypatch.delenv("TPU3DRECON_CACHE_DISABLE", raising=False)
        monkeypatch.setattr(
            jax.config, "update", lambda k, v: calls.append((k, v))
        )
        return calls

    def test_env_dir_honoured_and_nothing_set(self, monkeypatch, tmp_path, updates):
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        assert compile_cache.enable_compilation_cache() == str(tmp_path)
        assert compile_cache.cache_dir() == tmp_path
        assert updates == []

    def test_default_is_fixed_checkout_path(self, monkeypatch, updates):
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        expected = REPO / ".jax_cache"
        assert compile_cache.DEFAULT_DIR == expected
        assert compile_cache.enable_compilation_cache() == str(expected)
        assert updates == [("jax_compilation_cache_dir", str(expected))]

    def test_disabled_is_a_no_op(self, monkeypatch, updates):
        monkeypatch.setenv("TPU3DRECON_CACHE_DISABLE", "1")
        assert compile_cache.enable_compilation_cache() == ""
        assert updates == []

    def test_entry_count(self, monkeypatch, tmp_path):
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "c"))
        assert compile_cache.cache_entry_count() == 0
        (tmp_path / "c").mkdir()
        for i in range(3):
            (tmp_path / "c" / f"e{i}").write_bytes(b"x")
        assert compile_cache.cache_entry_count() == 3


class TestNoAcceleratorNoResult:
    @pytest.mark.parametrize(
        "argv", [[], ["--suite"], ["--engine", "wtt"]],
        ids=["headline", "suite", "engine"],
    )
    def test_bench_exits_nonzero_without_gpu(self, argv, capsys):
        sys.path.insert(0, str(REPO))
        import bench

        assert bench.main(argv) == 2
        out = capsys.readouterr()
        assert out.out == ""
        assert "needs an accelerator" in out.err

    def test_chip_smoke_refuses_cpu(self, capsys):
        sys.path.insert(0, str(REPO))
        import chip_smoke

        assert chip_smoke.main([]) == 1
        assert chip_smoke.main(["--four"]) == 1
        out = capsys.readouterr()
        assert out.out == ""
        assert "needs a GPU" in out.err

    def test_chip_smoke_alone_fails(self, tmp_path):
        """Copied out of the repository, the script cannot import the
        system it checks, and prints no result."""
        (tmp_path / "chip_smoke.py").write_text(
            (REPO / "chip_smoke.py").read_text()
        )
        env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH="")
        proc = subprocess.run(
            [sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
            capture_output=True, text=True, timeout=120,
        )
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout

"""The helpers that the GPU scripts share (``chip_env.py``) and the
benchmark's device bookkeeping (``bench.py``): peak table, compile-cache
rule, ``nvidia-smi`` parsing, the result line, the device guard, and the
device fields and exit code of a benchmark run. All run on the CPU."""

import json
import sys
from pathlib import Path

import jax
import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import bench  # noqa: E402
import chip_env  # noqa: E402


class TestPeakTable:
    def test_h100_row_resolves(self):
        fp32, bf16, hbm, tf32 = bench.peaks_for("NVIDIA H100 80GB HBM3")
        assert (fp32, bf16, hbm, tf32) == (67_000.0, 989_000.0, 3350.0,
                                            495_000.0)

    @pytest.mark.parametrize(
        "kind", ["TPU v5 lite", "NVIDIA A100-SXM4-80GB", "cpu", ""]
    )
    def test_unknown_kind_raises(self, kind):
        with pytest.raises(KeyError, match="no published peaks"):
            bench.peaks_for(kind)

    def test_cpu_run_reports_not_measured(self, capsys, monkeypatch):
        monkeypatch.setenv("BENCH_CPU", "1")
        assert bench._device_peaks() is None
        bench._not_measured("x_util")
        line = json.loads(capsys.readouterr().out.strip())
        assert line["value"] == "not measured"
        assert line["platform"] == "cpu"

    def test_device_without_a_row_raises(self, monkeypatch):
        # only a BENCH_CPU smoke run may skip the table; any other device,
        # the CPU included, must have a row
        monkeypatch.delenv("BENCH_CPU", raising=False)
        with pytest.raises(KeyError, match="no published peaks"):
            bench._device_peaks()


class TestCompileCacheRule:
    def test_environment_variable_is_honoured(self, monkeypatch, tmp_path):
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        assert chip_env.compile_cache_dir() == str(tmp_path)
        before = jax.config.jax_compilation_cache_dir
        assert chip_env.setup_compile_cache() == str(tmp_path)
        # JAX reads the variable itself: nothing is set in code
        assert jax.config.jax_compilation_cache_dir == before

    def test_default_is_the_fixed_in_checkout_path(self):
        path = chip_env.compile_cache_dir(environ={})
        assert path == str(ROOT / ".jax_cache")
        assert Path(path).is_absolute()
        assert ".jax_cache/" in (ROOT / ".gitignore").read_text()


class TestNvidiaSmi:
    @pytest.mark.parametrize(
        "text, cards",
        [
            ("NVIDIA H100 80GB HBM3, 700.00 W\n",
             [("NVIDIA H100 80GB HBM3", "700.00 W")]),
            ("NVIDIA H100 80GB HBM3, 500.00 W\n" * 4,
             [("NVIDIA H100 80GB HBM3", "500.00 W")] * 4),
            ("Some, Card, With Commas, 350.00 W",
             [("Some, Card, With Commas", "350.00 W")]),
        ],
    )
    def test_parse(self, text, cards):
        assert chip_env.parse_nvidia_smi(text) == cards

    @pytest.mark.parametrize("text", ["", "no comma here", "name,  "])
    def test_malformed_raises(self, text):
        with pytest.raises(ValueError):
            chip_env.parse_nvidia_smi(text)


class TestResultLineAndGuard:
    def test_last_line_shape(self):
        line = chip_env.result_line()
        obj = json.loads(line)
        assert list(obj) == ["ok", "device"]
        assert obj["ok"] is True
        assert obj["device"] == {
            "platform": jax.devices()[0].platform,
            "kind": jax.devices()[0].device_kind,
            "count": len(jax.devices()),
        }
        assert "\n" not in line

    def test_device_guard_raises_on_cpu(self):
        with pytest.raises(chip_env.NoGPUError, match="no GPU"):
            chip_env.require_gpu()

    def test_device_fields(self):
        fields = chip_env.device_fields()
        assert fields == {
            "platform": "cpu",
            "device_kind": jax.devices()[0].device_kind,
            "device_count": len(jax.devices()),
        }


class TestBenchLines:
    def test_every_emitted_line_names_the_device(self, capsys, monkeypatch,
                                                 tmp_path):
        monkeypatch.chdir(tmp_path)
        monkeypatch.setattr(bench, "_EMITTED", [])
        bench.emit("some_metric", 123.456, "things/sec")
        line = json.loads(capsys.readouterr().out.strip())
        assert line["metric"] == "some_metric"
        for key in ("platform", "device_kind", "device_count"):
            assert key in line
        assert "vs_baseline" not in line

    def test_failed_mode_makes_the_run_exit_nonzero(self, capsys,
                                                    monkeypatch, tmp_path):
        monkeypatch.chdir(tmp_path)
        monkeypatch.setenv("BENCH_CPU", "1")
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        monkeypatch.delenv("BENCH_MODE", raising=False)
        monkeypatch.setattr(bench, "_EMITTED", [])
        ran = []

        def ok_mode(name):
            return lambda: ran.append(name)

        def broken():
            raise RuntimeError("boom")

        modes = {name: ok_mode(name) for name in bench.MODES}
        modes["sir"] = broken
        monkeypatch.setattr(bench, "MODES", modes)
        assert bench.main() == 1
        out = capsys.readouterr().out
        errors = [json.loads(l) for l in out.splitlines() if "_error" in l]
        assert [e["metric"] for e in errors] == ["sir_error"]
        assert errors[0]["platform"] == "cpu"
        # the remaining modes still ran
        assert set(ran) == set(bench.MODES) - {"sir"}

    def test_clean_run_exits_zero(self, monkeypatch, tmp_path):
        monkeypatch.chdir(tmp_path)
        monkeypatch.setenv("BENCH_CPU", "1")
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        monkeypatch.delenv("BENCH_MODE", raising=False)
        monkeypatch.setattr(
            bench, "MODES", {name: (lambda: None) for name in bench.MODES}
        )
        assert bench.main() == 0

    def test_main_refuses_the_cpu(self, monkeypatch, tmp_path):
        # without BENCH_CPU the benchmark measures the GPU or nothing
        monkeypatch.chdir(tmp_path)
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        monkeypatch.delenv("BENCH_CPU", raising=False)
        monkeypatch.delenv("BENCH_MODE", raising=False)
        ran = []
        monkeypatch.setattr(
            bench, "MODES",
            {name: (lambda name=name: ran.append(name)) for name in bench.MODES},
        )
        with pytest.raises(chip_env.NoGPUError, match="no GPU"):
            bench.main()
        assert ran == []

    def test_no_tpu_only_modes(self):
        assert not [m for m in bench.MODES if "pallas" in m]

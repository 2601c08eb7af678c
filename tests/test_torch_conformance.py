"""The port's conformance runner (audio_raytracer_tpu_torch.conformance):
configs 1-5 must PASS through the one-command entry point at --fast
sizes on the CPU (configs 1-3 through the CUDA kernels' plain versions,
config 4 in float64 through the dense tier, config 5 on 8 spawned ranks
over gloo), and a failing gate must flip the exit code, as
tests/test_conformance.py holds the JAX runner."""

import pytest
import torch

import audio_raytracer_tpu_torch.conformance as conf

torch.set_num_threads(1)


class TestConformance:
    def test_all_configs_pass_fast(self, capsys):
        rc = conf.main(["--fast", "--device", "cpu"])
        out = capsys.readouterr().out
        assert "conformance: 5/5 PASS" in out, out
        assert rc == 0
        for i in range(1, 6):
            assert f"config {i} [" in out, out
        assert "FAIL" not in out, out

    def test_dense_backend_passes_config_1(self, capsys):
        rc = conf.main(["--fast", "--device", "cpu", "--backend", "dense",
                        "--only", "1"])
        out = capsys.readouterr().out
        assert rc == 0 and "conformance: 1/1 PASS" in out, out

    def test_only_selection_and_failure_exit_code(self, capsys,
                                                  monkeypatch):
        # A failing gate must flip the exit code (the runner is a CI
        # gate, not a report).
        monkeypatch.setitem(conf.CONFIGS, 1,
                            lambda args: (False, "injected failure"))
        rc = conf.main(["--fast", "--device", "cpu", "--only", "1"])
        out = capsys.readouterr().out
        assert rc == 1
        assert "conformance: 0/1 PASS" in out, out

    def test_a_crash_is_a_failure(self, capsys, monkeypatch):
        def crash(args):
            raise ValueError("injected crash")

        monkeypatch.setitem(conf.CONFIGS, 4, crash)
        rc = conf.main(["--fast", "--device", "cpu", "--only", "4"])
        out = capsys.readouterr().out
        assert rc == 1 and "exception: ValueError: injected crash" in out

    def test_runner_defaults_to_the_card(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA"):
            conf.main(["--fast", "--only", "1"])

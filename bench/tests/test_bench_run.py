"""The command as the driver runs it: with no card it exits with another
code than 0 and prints no result, here and in a directory that holds only
BENCHMARK.json and the benchmark's files."""

import json
import shutil
import subprocess
import sys

from bench.tests.conftest import ROOT

ARGS = ["--workload", "smollm-360m.train-b16-s2048", "--seed", str(2 ** 31 + 5),
        "--seconds", "1", "--trace", "0"]


def run_in(root):
    return subprocess.run([sys.executable, "bench/run.py", *ARGS], cwd=root,
                          capture_output=True, text=True, timeout=120,
                          env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})


def no_result(proc):
    for line in proc.stdout.splitlines():
        try:
            assert not isinstance(json.loads(line), dict)
        except json.JSONDecodeError:
            pass
    return proc.returncode != 0


def test_no_card_no_result():
    proc = run_in(ROOT)
    assert no_result(proc) and "CUDA card" in proc.stderr


def test_benchmark_files_alone_give_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    assert no_result(run_in(tmp_path))

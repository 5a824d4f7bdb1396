"""Runs one cell of the benchmark once and prints its result as the last
line of standard output (README.md):

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Exits with another code than 0, printing no result, where no CUDA card is
found (or fewer than the cell asks for), where the port is missing, or where
the process holds JAX or the JAX package once the run has ended.
"""

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# every build and kernel cache of the run at a fixed path inside the checkout
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
os.environ["CUDA_CACHE_PATH"] = str(ROOT / "build" / "cuda_cache")
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True, help="a cell's name in BENCHMARK.json")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True, help="the measured window")
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0,
                    help="1: profile whole groups of steps, print the per-layer metrics")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    import torch

    from bench import harness

    spec = harness.load_spec(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < spec["chips"]:
        print(f"{args.workload} needs {spec['chips']} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    result, at = harness.run_cell(spec, args.seed, args.seconds, bool(args.trace), device,
                                  T_START, log=lambda msg: print(msg, file=sys.stderr))
    found = harness.loaded_forbidden()
    if found:
        print(f"the run loaded {found}: the benchmark runs the port alone", file=sys.stderr)
        return 3
    for name, check in result["checks"].items():
        ok = "ok" if check["value"] <= check["limit"] else "FAIL"
        print(f"check {name} {check['value']!r} limit {check['limit']!r} ({at[name]}) {ok}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())

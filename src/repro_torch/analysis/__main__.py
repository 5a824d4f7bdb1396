"""CLI: ``python -m repro_torch.analysis`` (also ``make lint``): the port's
copy of ``python -m repro.analysis``, with the same options and exit codes,
over ``src/repro_torch``.

Exit status 0 only when every finding is covered by ``baseline.json``,
every baseline entry carries a reason, and no entry is stale (matching
nothing — a fixed exception must be deleted, not carried forward).
``--write-baseline`` seeds the file from current findings with TODO
reasons for a human to justify.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

from repro_torch.analysis import run_analysis
from repro_torch.analysis.base import BASELINE_PATH, Baseline


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Run the invariant analyzer suite over src/repro_torch.",
    )
    parser.add_argument("--root", default=None,
                        help="repo root to analyze (default: this repo)")
    parser.add_argument("--baseline", default=None,
                        help="baseline JSON path (default: the committed one)")
    parser.add_argument("--write-baseline", action="store_true",
                        help="write current findings as the new baseline "
                             "(reasons left as TODO for human review)")
    parser.add_argument("-q", "--quiet", action="store_true",
                        help="suppress per-finding output, print summary only")
    args = parser.parse_args(argv)

    t0 = time.perf_counter()
    result = run_analysis(args.root)
    elapsed = time.perf_counter() - t0

    baseline_path = Path(args.baseline) if args.baseline else BASELINE_PATH
    if args.write_baseline:
        entries = [
            {"key": f.key, "reason": "TODO: justify this exception",
             "note": f.render()}
            for f in result.findings
        ]
        baseline_path.write_text(json.dumps(entries, indent=2) + "\n")
        print(f"wrote {len(entries)} baseline entries to {baseline_path}")
        return 0

    baseline = Baseline.load(baseline_path)
    new, old = result.split(baseline)
    unjustified = baseline.unjustified()
    stale = baseline.stale()

    if not args.quiet:
        for f in new:
            print(f.render())
        for entry in unjustified:
            print(f"baseline entry without a reason: {entry.get('key')}")
        for entry in stale:
            print(f"stale baseline entry (matches nothing): {entry.get('key')}")

    status = "FAIL" if (new or unjustified or stale) else "ok"
    print(
        f"repro_torch.analysis: {status} — {result.files} files, "
        f"{len(new)} new finding(s), {len(old)} baselined, "
        f"{len(stale)} stale, {elapsed:.2f}s"
    )
    return 1 if (new or unjustified or stale) else 0


if __name__ == "__main__":
    sys.exit(main())

"""CLI: ``python -m repro_torch.analysis [paths] [--baseline FILE]``.

Exit status is 0 when every finding is baselined or suppressed, 1 when
new findings exist, 2 on usage errors.
"""
from __future__ import annotations

import argparse
import os
import sys
from collections import Counter

from repro_torch.analysis import CHECKERS, scan
from repro_torch.analysis.core import Baseline


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Static analysis of the PyTorch port's device hazards.",
    )
    parser.add_argument(
        "paths",
        nargs="*",
        default=None,
        help="files/directories to scan (default: src/repro_torch)",
    )
    parser.add_argument("--baseline", help="baseline file of grandfathered findings")
    parser.add_argument(
        "--write-baseline",
        metavar="FILE",
        help="write current findings as the new baseline and exit 0",
    )
    parser.add_argument(
        "--root", default=".", help="repo root findings are reported relative to"
    )
    parser.add_argument("--list-codes", action="store_true", help="list checkers and exit")
    args = parser.parse_args(argv)

    if args.list_codes:
        import repro_torch.analysis.checkers  # noqa: F401

        for name in sorted(CHECKERS):
            print(name)
        return 0

    root = os.path.abspath(args.root)
    paths = args.paths or [os.path.join(root, "src", "repro_torch")]
    for p in paths:
        if not os.path.exists(p):
            print(f"error: no such path: {p}", file=sys.stderr)
            return 2

    result = scan(paths, root)
    findings = result.findings

    if args.write_baseline:
        Baseline.write(args.write_baseline, findings)
        print(f"wrote {len(findings)} finding(s) to {args.write_baseline}")
        return 0

    baseline = Baseline.load(args.baseline) if args.baseline else Baseline(set())
    new, grandfathered, stale = baseline.split(findings)

    for f in new:
        print(f.render())
    counts = Counter(f.code for f in new)
    summary = ", ".join(f"{code}={n}" for code, n in sorted(counts.items())) or "none"
    print(
        f"repro_torch.analysis: {len(new)} new finding(s) [{summary}], "
        f"{len(grandfathered)} baselined, {len(stale)} stale baseline entr"
        f"{'y' if len(stale) == 1 else 'ies'}"
    )
    sup = Counter(f.code for f in result.suppressed)
    print(
        f"  {len(result.project.roots)} device region(s), "
        f"{len(result.project.device_funcs)} device function(s), "
        f"{len(result.suppressed)} suppressed inline "
        f"[{', '.join(f'{c}={n}' for c, n in sorted(sup.items())) or 'none'}]"
    )
    for key in stale:
        print(f"  stale baseline entry (fixed? remove it): {key}")
    return 1 if new else 0


if __name__ == "__main__":
    sys.exit(main())

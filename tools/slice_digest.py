#!/usr/bin/env python3
"""Run another tree's chip_smoke.py with the results digest of this
tree's chip_smoke.py printed after each slice, so that two trees' slice
outputs (senders, ok masks, roots, seal verdicts on both chains and both
EC routes) compare by their `results digest` lines, and each slice's
device time by kernel (`device us by kernel` lines, every kernel of the
port, as this tree's chip_smoke.py prints them by counter).

    python3 tools/slice_digest.py OTHER_TREE

OTHER_TREE holds chip_smoke.py and fisco_bcos_tpu_torch/ (for example an
unpacked `git archive` of the parent commit). Needs a CUDA card, as
chip_smoke.py does; exits with its code.
"""

from __future__ import annotations

import importlib.util
import sys
from pathlib import Path


def _load(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> int:
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    other = Path(sys.argv[1]).resolve()
    ours = _load("chip_smoke_ours", Path(__file__).resolve().parent.parent / "chip_smoke.py")
    theirs = _load("chip_smoke_theirs", other / "chip_smoke.py")
    run = theirs.phase_slice

    def phase_slice(*a, **k):
        launches, phases, results = run(*a, **k)
        suite = a[1]
        print(f"[slice {suite.kind} {suite.ec_route}] results digest "
              f"{ours.results_digest(results)}", flush=True)
        return launches, phases, results

    events = theirs.device_events

    def device_events(prof, tag):
        us, calls = events(prof, tag)
        if tag.startswith("[slice"):
            print(f"{tag} device us by kernel: " + ", ".join(
                f"{k} {v:.1f} ({calls[k]})" for k, v in sorted(us.items())
                if k.endswith("_kernel")), flush=True)
        return us, calls

    theirs.phase_slice = phase_slice
    theirs.device_events = device_events
    sys.argv = [str(other / "chip_smoke.py")]
    return theirs.main()


if __name__ == "__main__":
    sys.exit(main())
